"""Whether what the timed path produced is correct: the plain reference
(`reference/`, eager PyTorch that imports nothing of the program) works
out the same answers from the same inputs, and each number compared is
held to its limit (`checks/<cell>.json`).

Frames (`compare_frames`), for the window's first frame, its last and a
sample drawn from the seed:
- `frame_q999` and `frame_mean`: the 99.9th percentile and the mean of
  |program's frame - reference's frame| over the frame's RGB values, the
  worst frame's; the reference renders the frame's key from the scene it
  builds itself;
- `accumulate_max`: the largest |buffer after - the running mean of the
  buffer before and the frame| (the reference's own arithmetic over the
  program's buffer and frame: this follows the accumulation step by step
  from the program's state; the first frame starts from zeros).

Training (`compare_train`), the first steps set-up drove through the
window's own call: the reference builds the true and start scenes,
renders the target and takes the same steps (eager renders, autograd,
Adam written out). Each number is a gap of norms taken at the worst
leaf, against the reference's norm of that leaf or of the median leaf,
whichever is larger:
- `loss_gap`: the relative gap of each step's loss, the worst step's;
- `grad_gap`: of the first gradient (Adam's first moment after one step
  over 1 - beta1);
- `change_gap`: of the leaves' change over the checked steps, leaving out
  the leaves whose reference gradient is under a thousandth of the
  median leaf's (Adam moves those by round-off alone);
- `grad_gap_median`, `change_gap_median`: the median leaf's gap, by the
  gaps, where `grad_gap` and `change_gap` take the worst.

- `grad_gap_masked` (where the check file gives `grazing`): `grad_gap`
  with two kinds of pixels left out of the loss on both sides, as
  chip_smoke.py's phase 13 leaves them out: those whose first render
  meets the SDF at |<rd, n>| under `grazing` on the reference's path
  (`reference/grazing.py`), and those where the program's first render,
  second render or target differs from the reference's by more than
  EDGE (a path that took another branch). The program's trainer takes
  the first step's renders and loss again on the same leaves, keys and
  target, through the window's renderer (K1 and K2) and loss; inf where
  more than MASKED_MAX of the pixels would go. A hit at small |<rd, n>|
  is placed only to HIT_EPS / |<rd, n>| along its ray by either side's
  march, and one such pixel can carry half of a geometry leaf's gradient,
  so the SDF trainer's `grad_gap` swings from seed to seed; this one
  holds K2's gradient of the geometry leaves too, its size included,
  which Adam's first steps do not show.

A cell's check file names the numbers it holds; the others are printed as
readings beside them.
"""

from __future__ import annotations

import math

import torch

from . import traffic as gen
from .reference import grazing, rng, scenes, tracer
from .reference import train as ref_train

SILENT_LEAF = 1e-3  # of the median leaf's gradient norm
EDGE = 1e-3  # a pixel whose frame differs by more took another branch (chip_smoke.py:390, EDGE_TOL)
MASKED_MAX = 0.03  # of the frame's pixels: a run that would leave out more reads inf on grad_gap_masked


def reference_scene(config: dict, device, dtype=torch.float32, key: str = "scene"):
    desc = config[key] if key == "scene" else config["train"][key]
    return scenes.scene_from_dict(desc, device=device, dtype=dtype)


def render_reference(scene, key, width: int, height: int, spp: int) -> torch.Tensor:
    with torch.no_grad():
        return tracer.render_frame(scene, key, width, height, spp=spp, quirks=tracer.VERBATIM, detach=True)


def accumulate_reference(before: torch.Tensor, frame: torch.Tensor, index: int) -> torch.Tensor:
    """The running mean after frame `index` (0-based): weight 1/(index+1),
    the count a float32 scalar on the buffer's device."""
    n = torch.tensor(float(index), dtype=torch.float32, device=before.device)
    w = 1.0 / (n + 1.0)
    return before * (1.0 - w) + frame * w


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(99.9th percentile, mean) of |got - want| over the RGB values."""
    d = (got[..., :3].to(torch.float64) - want[..., :3].to(torch.float64)).abs().reshape(-1)
    if not bool(torch.isfinite(d).all()):
        return math.inf, math.inf
    k = max(1, math.ceil(0.999 * d.numel()))
    return float(d.kthvalue(k).values), float(d.mean())


def compare_frames(records, scene, width: int, height: int, spp: int) -> dict:
    """The frames numbers of `records` [(index, key, frame, before,
    after)] against the reference `scene`."""
    q999 = mean = acc = 0.0
    for index, key, frame, before, after in records:
        want = render_reference(scene, key, width, height, spp)
        q, m = frame_numbers(frame, want)
        del want
        q999, mean = max(q999, q), max(mean, m)
        exact = accumulate_reference(before.to(torch.float32), frame.to(torch.float32), index)
        gap = (after.to(torch.float32) - exact).abs()
        acc = max(acc, float(gap.max()) if bool(torch.isfinite(gap).all()) else math.inf)
    return {"frame_q999": q999, "frame_mean": mean, "accumulate_max": acc}


def leaf_norms(tensors) -> list[float]:
    return [float(torch.linalg.vector_norm(t.detach().to(torch.float64))) for t in tensors]


def norm_gap(got, want, counted=None, pick=max) -> float:
    """`pick` (the largest by default) over the counted leaves of
    | |got_l| - |want_l| | / max(|want_l|, the median counted leaf's |want|)."""
    g, w = leaf_norms(got), leaf_norms(want)
    idx = [i for i in range(len(w)) if counted is None or counted[i]]
    if not idx:
        return 0.0
    med = sorted(w[i] for i in idx)[len(idx) // 2]
    gaps = [abs(g[i] - w[i]) / max(w[i], med, 1e-30) for i in idx]
    return pick(gaps) if all(math.isfinite(x) for x in gaps) else math.inf


def median(values):
    """The lower median: of 4 leaves the second smallest."""
    return sorted(values)[(len(values) - 1) // 2]


class FirstStep:
    """The reference's first training step without gradients, in `dtype`:
    the target (the true scene's renders), the two renders of the
    projected start scene on the keys split from the step's, and the
    pixels whose first render meets the SDF at |<rd, n>| < `below`
    (`near`; none on a scene of another family); `masked_grad(keep)` is
    that step's gradient over the pixels `keep` keeps."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, width: int, height: int, below: float,
                 dtype=torch.float32):
        c = config["train"]
        self.width, self.height, self.projection = width, height, ref_train.PROJECTIONS[c["projection"]]
        self.start = reference_scene(config, device, dtype, "start")
        self.names = ref_train.select(self.start, c["select"])
        self.ka, kb = rng.split(gen.step_key(seed, 0))
        true = reference_scene(config, device, dtype)
        self.target = ref_train.target_of(true, gen.target_keys(seed, int(traffic["target_frames"])), width, height)
        del true
        scene = self.projection(self.start)
        with torch.no_grad():
            self.a = ref_train.render(scene, self.ka, width, height)
            self.b = ref_train.render(scene, kb, width, height)
        if c["start"]["family"] == "sdf":
            near = (grazing.hit_cosines(scene, self.ka, width, height) < below).any(0)
        else:
            near = torch.zeros(width * height, dtype=torch.bool, device=self.a.device)
        self.near = near.reshape(height, width)
        self._last = None

    def keep_of(self, a, b, target):
        """([H, W, 1] float32 keep, {what: pixels}): 0 at the grazing
        pixels and where the other side's first render, second render or
        target differs from this one's by more than EDGE in a channel (its
        path took another branch there); keep None where more than
        MASKED_MAX of the pixels would go."""
        def edge(x, y):
            d = (x[..., :3].to(torch.float32) - y[..., :3].to(torch.float32)).abs().amax(-1)
            return ~(d <= EDGE)

        moved = edge(a, self.a) | edge(b, self.b) | edge(target, self.target)
        drop = self.near | moved
        counts = {"grazing": int(self.near.sum()), "branch": int((moved & ~self.near).sum())}
        if int(drop.sum()) > MASKED_MAX * drop.numel():
            return None, counts
        return (~drop).to(torch.float32)[..., None], counts

    def masked_grad(self, keep) -> list[torch.Tensor] | None:
        """None for keep None; the last keep's gradient again for the same
        keep."""
        if keep is None:
            return None
        if self._last is not None and torch.equal(self._last[0], keep):
            return self._last[1]
        train = [v.detach().clone().requires_grad_(True) for v in ref_train.leaf_values(self.start, self.names)]
        scene = self.projection(ref_train.replace_leaves(self.start, dict(zip(self.names, train))))
        a = ref_train.render(scene, self.ka, self.width, self.height)
        k = keep.to(device=a.device, dtype=a.dtype)
        loss = ref_train.paired_image_loss(a * k, self.b * k, self.target * k)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        out = [(torch.zeros_like(t) if g is None else g).detach().cpu() for g, t in zip(grads, train)]
        self._last = (keep, out)
        return out


class TrainReference:
    """The reference's run of the first steps: losses, first gradient and
    change of the trained leaves, in `dtype` (the target given, or
    rendered here); `masked_grad` is set by the caller where a number
    takes it (`FirstStep.masked_grad`)."""

    def __init__(self, config: dict, traffic: dict, steps: int, seed: int, device, dtype=torch.float32, size=None,
                 target=None):
        width, height = size or (int(traffic["width"]), int(traffic["height"]))
        c = config["train"]
        start = reference_scene(config, device, dtype, "start")
        names = ref_train.select(start, c["select"])
        if target is None:
            true = reference_scene(config, device, dtype)
            target = ref_train.target_of(true, gen.target_keys(seed, int(traffic["target_frames"])), width, height)
            del true
        tr = ref_train.Trainer(start, names, c["projection"], float(traffic["lr"]), width, height)
        start_values = [v.clone() for v in tr.values]
        self.names, self.losses, self.first_grad, self.masked_grad = names, [], None, None
        for i in range(steps):
            self.losses.append(tr.step(target, gen.step_key(seed, i)))
            if self.first_grad is None:
                self.first_grad = [g.detach().cpu() for g in tr.last_grads]
        self.change = [(v - s).cpu() for v, s in zip(tr.values, start_values)]


def compare_train(got: dict, want: TrainReference) -> dict:
    """The training numbers of the program's (or the control's) first
    steps `got` against the reference's `want`."""
    if got["names"] != want.names:
        raise ValueError(f"trained leaves {got['names']} against the reference's {want.names}")
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want.losses)]
    loss_gap = max(gaps) if all(math.isfinite(x) for x in gaps) else math.inf
    g = leaf_norms(want.first_grad)
    med = sorted(g)[len(g) // 2]
    counted = [x >= SILENT_LEAF * med for x in g]
    numbers = {"loss_gap": loss_gap, "grad_gap": norm_gap(got["first_grad"], want.first_grad),
               "change_gap": norm_gap(got["change"], want.change, counted),
               "grad_gap_median": norm_gap(got["first_grad"], want.first_grad, pick=median),
               "change_gap_median": norm_gap(got["change"], want.change, counted, pick=median)}
    if "masked_grad" in got:
        masked = got["masked_grad"] is not None and want.masked_grad is not None
        numbers["grad_gap_masked"] = norm_gap(got["masked_grad"], want.masked_grad) if masked else math.inf
    return numbers


def train_details(got: dict, want: TrainReference) -> list[str]:
    """Each leaf's norms, program (or control) against reference: the
    first gradient's and the change's; each step's loss."""
    lines = [f"loss step {i}: {a!r} against {b!r}" for i, (a, b) in enumerate(zip(got["losses"], want.losses))]
    for name, gg, wg, gc, wc in zip(want.names, leaf_norms(got["first_grad"]), leaf_norms(want.first_grad),
                                    leaf_norms(got["change"]), leaf_norms(want.change)):
        lines.append(f"leaf {name}: gradient {gg:.6e} against {wg:.6e}, change {gc:.6e} against {wc:.6e}")
    if got.get("masked_grad") is not None and want.masked_grad is not None:
        for name, gm, wm in zip(want.names, leaf_norms(got["masked_grad"]), leaf_norms(want.masked_grad)):
            lines.append(f"leaf {name}: masked gradient {gm:.6e} against {wm:.6e}")
    return lines


def verdict(numbers: dict, limits: dict) -> tuple[bool, int, dict]:
    """(correct, numbers over their limit, {name: {value, limit}}) of the
    numbers that `limits` holds, each at most its limit; a limit of no
    number raises."""
    out, failed = {}, 0
    for name, limit in limits.items():
        value = numbers[name]
        ok = math.isfinite(value) and value <= float(limit)
        failed += not ok
        out[name] = {"value": value, "limit": float(limit)}
    return failed == 0, failed, out
