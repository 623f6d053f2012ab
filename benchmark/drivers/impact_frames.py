"""Impact frames: the dam break past first contact with its obstacle,
stepped in frames through `FluidSimulation.run`, in episodes that restart
from a snapshot held on the device.

Traffic keys: those of fluid_frames, and
- preroll_steps: steps from the seeded column to the episodes' start (the
  snapshot), run once in set-up; a multiple of steps_per_frame;
- start_frame: the episode frame the window opens at. Set-up steps on from
  the snapshot to it (warm-up frames included), so the window's first
  episode runs from there to its end, and the traced frames (the window's
  frames PROFILER_WARMUP onwards) lie that far into the impact;
- check_from_frame: the first episode frame the checked frames are drawn
  from, after frame 0.

Set-up builds the seeded column, steps it preroll_steps steps, takes one
`FluidSimulation.snapshot()` and steps on to start_frame, all inside
setup_s; every later episode starts with `restore(snapshot)`, untimed, in
before_frame. Frames are numbered from the snapshot (window frame i is
frame start_frame + i). Before the pre-roll it checks that the program
has `snapshot` and `restore` and that `counters()` has `pushed`, and
exits at once where it lacks them.

Checked frames: frame 0 of the first episode that starts in the window
(the snapshot restored) and one frame drawn from the seed in each third of
its frames check_from_frame to check_within_frames. Each is compared as
fluid_frames compares, with `lost` counting the pre-roll's drops once, and
three more numbers: `clamped`, the lanes the speed limit held over the
pre-roll and every step after it; `push_missed`, the checked frames after
frame 0 in which the reference's own obstacle push (nonzero rows of its
`_obstacle_accel` at a step's start) acts on no particle in any step, so
that the check compares the push (frame 0 is the earliest first contact
over the seeds measured, so the push may not act there yet); and
`push_gap`, Σ |program's pushed lanes − reference's| over the checked
frames' steps ÷ the reference's sum, the program's taken from F1's count
(`ops.obstacle_pushed`) across each checked frame. `finish` adds
`pushed_per_step`, the program's pushed lanes a step over the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import fluid_frames
from benchmark.harness.frames import worst


class Driver(fluid_frames.Driver):
    def __init__(self, cell, seed, device, log):
        super().__init__(cell, seed, device, log)
        t = self.traffic
        self.episode = int(t["episode_frames"])
        self.start = int(t["start_frame"])
        within = int(t["check_within_frames"])
        first = int(t["check_from_frame"])
        if not (int(t["warmup_frames"]) <= self.start < self.episode
                and 0 < first < within <= self.episode):
            raise SystemExit(
                "impact traffic needs warmup_frames <= start_frame < "
                "episode_frames and 0 < check_from_frame < "
                "check_within_frames <= episode_frames")
        # Frame 0 of the window's first whole episode, and one frame from
        # each third of its frames `first` to `within`.
        self.first = -(-self.start // self.episode) * self.episode
        rng = np.random.default_rng([seed, 19])
        edges = [first + (within - first) * k // 3 for k in range(4)]
        self.check_frames = {self.first, *(
            self.first + int(rng.integers(a, b))
            for a, b in zip(edges, edges[1:]))}

    def setup(self) -> None:
        from sph_tpu_torch.engine.fluid import FluidSimulation

        missing = [m for m in ("snapshot", "restore")
                   if not hasattr(FluidSimulation, m)]
        if missing:
            raise SystemExit(
                f"the program's FluidSimulation has no {' or '.join(missing)}"
                ": this traffic restarts its episodes from a device snapshot")
        self.snap = None
        self.window_steps = 0
        super().setup()
        # The parent counts pairs at window frames; frames here run from
        # the snapshot.
        self.count_at = {i + self.start for i in self.count_at}
        self.log(f"window frame 0 is frame {self.start} of its episode; "
                 f"checked frames {sorted(self.check_frames)} are window "
                 f"frames {sorted(f - self.start for f in self.check_frames)}")

    def _restart(self) -> None:
        if self.snap is None:
            self._preroll()
            return
        self._read_counters(final=True)
        self.sim.restore(self.snap)

    def _preroll(self) -> None:
        """The seeded column stepped to the episodes' start, its snapshot,
        and the steps on to the window's first frame but the warm-up's;
        the pre-roll's drops and clamps are counted once."""
        from sph_tpu_torch.engine.fluid import FluidSimulation
        from sph_tpu_torch.sph.model import SPHState

        self.sim = FluidSimulation(
            SPHState.from_positions(self.pos0, self.params), self.params,
            substeps=self.steps_per_frame, device=self.device)
        if "pushed" not in self.sim.counters():
            raise SystemExit("the program's FluidSimulation.counters() has "
                             "no `pushed`: this traffic reads the obstacle "
                             "push's count")
        steps = int(self.traffic["preroll_steps"])
        if steps % self.steps_per_frame:
            raise SystemExit(f"preroll_steps {steps} is not a multiple of "
                             f"steps_per_frame {self.steps_per_frame}")
        t = time.perf_counter()
        self.sim.run(steps)
        self.base = tuple(self._counters()[:2])
        self.dropped += self.base[0]
        self.clamped += self.base[1]
        self.snap = self.sim.snapshot()
        on = (self.start - int(self.traffic["warmup_frames"])) \
            * self.steps_per_frame
        self.sim.run(on)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"pre-roll: {steps} steps, then {on} from the snapshot "
                 f"({time.perf_counter() - t:.3f} s); dropped {self.base[0]}"
                 f", clamped {self.base[1]} to the snapshot")

    def _read_counters(self, final: bool = False) -> None:
        dropped, clamped, peak = self._counters()
        self.peak = max(self.peak, peak)
        if final:
            # The state carries the pre-roll's counts.
            self.dropped += dropped - self.base[0]
            self.clamped += clamped - self.base[1]

    def _pushed(self):
        return self.sim.counters()["pushed"].clone()

    def before_frame(self, i: int) -> None:
        if i == 0:
            from sph_tpu_torch.ops import reset_obstacle_pushed

            reset_obstacle_pushed()
        f = i + self.start
        super().before_frame(f)
        if f in self.snaps:
            self.snaps[f]["pushed"] = self._pushed()

    def after_frame(self, i: int) -> None:
        if i < 0:
            super().after_frame(i)
            return
        f = i + self.start
        super().after_frame(f)
        if f in self.snaps:
            self.snaps[f]["pushed"] = self._pushed() - self.snaps[f]["pushed"]
        self.window_steps += self.steps_per_frame

    def finish(self) -> dict:
        pushed = int(self.sim.counters()["pushed"])
        info = super().finish()
        info["pushed_per_step"] = pushed / max(self.window_steps, 1)
        return info

    # -- correctness ---------------------------------------------------------

    def _reference(self, start: dict, dtype) -> tuple[dict, int]:
        """The reference's frame from `start`, a step at a time (the same
        bits as one `run` of the frame's steps), and the particles its
        obstacle push acted on, summed over the steps."""
        s, pushed = start, 0
        for _ in range(self.steps_per_frame):
            acc = self.ref._obstacle_accel(s["pos"].to(dtype), self.ph)
            pushed += int((acc != 0).any(-1).sum())
            s = self.ref.run(s, self.ph, 1, dtype=dtype)
        return s, pushed

    def check(self, control: bool = False) -> dict:
        """The compared numbers, worst over the checked frames. control:
        the reference in bfloat16 stands in the program's place."""
        readings, missed, diff, total = [], 0, 0, 0
        for f in sorted(self.snaps):
            snap = self.snaps[f]
            if "end" not in snap:
                continue
            want, n_ref = self._reference(snap["start"], torch.float32)
            if control:
                got, n_got = self._reference(snap["start"], torch.bfloat16)
            else:
                got, n_got = snap["end"], int(snap["pushed"])
            r = fluid_frames.compare(got, want, self.ph)
            self.log(f"check frame {f}: "
                     + ", ".join(f"{k} {v!r}" for k, v in r.items())
                     + f"; pushed lanes {n_got}, the reference's {n_ref}")
            readings.append(r)
            missed += f > self.first and n_ref == 0
            diff += abs(n_got - n_ref)
            total += n_ref
        out = worst(readings)
        if not readings:
            out = {"lost": float("inf")}
        if not control:
            out["lost"] = out.get("lost", 0.0) + float(self.dropped)
        out["push_missed"] = float(missed)
        out["push_gap"] = diff / max(total, 1)
        out["clamped"] = float(self.clamped)
        return out
