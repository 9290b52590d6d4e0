"""The port's loop-closing math on the card against the same calls on the
CPU. Imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_loop_gpu.py

Tolerances: word ids and signatures equal (+/-1 products and integer
counts are exact with TF32 off); ``posegraph.close_loops`` within 1e-4
(f32 Gauss-Newton: cuBLAS and cuSOLVER sum in their own orders). Every
test skips where ``torch.cuda.is_available()`` is False."""

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch.core import lie
from semantic_slam_master_tpu_torch.slam import bow, posegraph

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _desc(rng, n):
    return torch.from_numpy(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32).astype(np.int64))


@pytest.mark.parametrize("n,num_words", [(1000, 1024), (300, 64), (1, 16)])
def test_assign_words_and_signature_on_card_equal_cpu(cuda, n, num_words):
    rng = np.random.default_rng(n)
    vocab, desc = bow.make_vocabulary(num_words, seed=n), _desc(rng, n)
    valid = torch.from_numpy(rng.random(n) < 0.9)
    ids = bow.assign_words(desc, vocab)
    ids_gpu = bow.assign_words(desc.to(cuda), vocab.to(cuda))
    assert torch.equal(ids_gpu.cpu(), ids)
    sig = bow.tf_signature(ids, valid, num_words)
    sig_gpu = bow.tf_signature(ids_gpu, valid.to(cuda), num_words)
    assert torch.equal(sig_gpu.cpu(), sig)


def test_train_vocabulary_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(3)
    corpus = _desc(rng, 4000)
    vocab = bow.train_vocabulary(corpus, num_words=256)
    assert torch.equal(bow.train_vocabulary(corpus.to(cuda), num_words=256).cpu(), vocab)


@pytest.mark.parametrize("K,loops", [(12, [(0, 11)]), (40, [(0, 39), (0, 20), (5, 38)]), (100, [(2, 97)])])
def test_close_loops_on_card_within_1e4_of_cpu(cuda, K, loops):
    def walk(xi):
        step = lie.se3_exp(torch.tensor(xi, dtype=torch.float64)).numpy()
        out = [np.eye(4)]
        for _ in range(K - 1):
            out.append(out[-1] @ step)
        return np.stack(out)

    gt = walk([0.2, 0, 0.01, 0, 2 * np.pi / K, 0.01])
    est = torch.tensor(walk([0.205, 0.003, 0.01, 0.002, 2 * np.pi / K + 0.004, 0.01]), dtype=torch.float32)
    edges = [(a, b, torch.tensor(np.linalg.inv(gt[a]) @ gt[b], dtype=torch.float32), 5.0) for a, b in loops]
    cpu = posegraph.close_loops(est, edges)
    gpu = posegraph.close_loops(est.to(cuda), [(a, b, T.to(cuda), w) for a, b, T, w in edges])
    torch.testing.assert_close(gpu.cpu(), cpu, atol=1e-4, rtol=0)
    assert not torch.allclose(cpu, est, atol=1e-3)  # the loops moved the graph
