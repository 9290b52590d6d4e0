"""What a drive's window returns."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class WindowResult:
    elapsed_s: float = 0.0
    passes: int = 0
    frames: int = 0
    attempted: int = 0  # passes, or frames for a drive that times frames
    metrics: dict = field(default_factory=dict)  # end-to-end metrics by name
    notes: dict = field(default_factory=dict)  # printed beside them
    poses: list = field(default_factory=list)  # (F, 4, 4) of every pass
    sample: dict = field(default_factory=dict)  # weight_map, features of one pass drawn from the seed
    pass_s: list = field(default_factory=list)  # host seconds of each pass

    def add_pass(self, rng, frames: int, weight_map, features, poses, seconds: float) -> None:
        """Count a pass, keep its poses, and keep its maps and features in
        place of the kept ones with probability 1/passes (a sample of one
        drawn from the seed)."""
        self.passes += 1
        self.frames += frames
        self.pass_s.append(seconds)
        self.attempted += 1
        if poses is not None:
            self.poses.append(poses)
        if rng.random() < 1.0 / self.passes:
            self.sample = {"weight_map": weight_map, "features": features}
