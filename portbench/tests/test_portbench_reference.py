"""The frozen plain reference against the port's eager tier on the CPU, at
a small size, on both configurations: the same frames bit for bit, the
same training steps (losses, first gradient, the leaves after the steps),
the same first gradient with pixels left out of the loss, the same work
counts as the port's own counter (`tools/work.py`), and the SDF hits'
cosines as the port's (`ops/megakernel_sdf.hit_cosines`)."""

import pytest
import torch

from portbench import check, drivers, spec
from portbench import traffic as gen
from portbench.reference import grazing, scenes
from portbench.reference import train as ref_train
from portbench.reference import work as ref_work

W, H = 24, 16
CONFIGS = ("analytical.frames", "sdf.frames")
TRAINS = ("analytical.train", "sdf.train")


def port_scene(desc):
    from pathtracer_tpu_torch.utils.sceneio import scene_from_dict

    return scene_from_dict(desc, device="cpu")


@pytest.mark.parametrize("cell", CONFIGS)
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_frame_is_the_ports_eager_frame(cell, seed):
    from pathtracer_tpu_torch.integrator import tracer as port_tracer

    config = spec.resolve(cell).config
    ref = check.reference_scene(config, "cpu")
    port = port_scene(config["scene"])
    keys = gen.frame_keys(seed)
    for _ in range(2):
        key = next(keys)
        want = port_tracer.render_frame(port, key, W, H, spp=1, detach=True)
        got = check.render_reference(ref, key, W, H, 1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("cell", CONFIGS)
def test_scene_leaves_are_the_ports(cell):
    from pathtracer_tpu_torch.integrator.inverse import named_leaves

    config = spec.resolve(cell).config
    ref = scenes.named_leaves(check.reference_scene(config, "cpu"))
    port = dict(named_leaves(port_scene(config["scene"])))
    assert list(ref) == list(port)
    for name in ref:
        assert torch.equal(ref[name], port[name]), name


@pytest.mark.parametrize("cell", TRAINS)
def test_training_steps_are_the_ports(cell):
    from pathtracer_tpu_torch.integrator import inverse, tracer

    c = spec.resolve(cell)
    t, steps = c.traffic, int(c.checks["steps"])
    want = check.TrainReference(c.config, t, steps, 11, "cpu", size=(W, H))
    true = port_scene(c.config["scene"])
    start = port_scene(c.config["train"]["start"])
    train, rebuild, names = inverse.select_leaves(start, c.config["train"]["select"])
    assert names == want.names
    start_values = [v.detach().clone() for v in train]
    opt = inverse.make_adam(train, float(t["lr"]))
    render = inverse.make_renderer("eager", W, H, 1, tracer.VERBATIM)
    with torch.no_grad():
        keys = gen.target_keys(11, int(t["target_frames"]))
        target = sum(render(true, k) for k in keys) / float(len(keys))
    projection = getattr(inverse, c.config["train"]["projection"])
    for i in range(steps):
        loss = inverse.paired_step(train, rebuild, projection, opt, render, target, gen.step_key(11, i))
        assert float(loss) == want.losses[i]
        if i == 0:
            grads = [opt.state[p]["exp_avg"] / 0.1 for p in train]
            for g, w in zip(grads, want.first_grad):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-12)
    for p, s, d in zip(train, start_values, want.change):
        torch.testing.assert_close(p.detach() - s, d, rtol=1e-5, atol=1e-8)


class Leaving:
    """A FirstStep stand-in whose keep leaves out a fixed set of pixels."""

    def __init__(self, keep):
        self.keep = keep

    def keep_of(self, a, b, target):
        return self.keep, {}


@pytest.mark.parametrize("cell", TRAINS)
def test_masked_gradient_is_the_ports(cell):
    """The port's trainer (the driver on the CPU, the port's eager tier)
    and the reference take the same first gradient with a third of the
    pixels left out; with none left out it is the step's own."""
    from portbench.tracing import Spans

    c, seed = spec.resolve(cell), 2**31 + 3
    keep = (torch.rand((H, W, 1), generator=torch.Generator().manual_seed(5)) > 1 / 3).to(torch.float32)
    driver = drivers.Train(c, seed, torch.device("cpu"), Spans(), (W, H))
    driver.setup()
    got, kept, _ = driver.masked_grad(Leaving(keep))
    whole = driver.masked_grad(Leaving(torch.ones_like(keep)))[0]
    first = check.FirstStep(c.config, c.traffic, seed, "cpu", W, H, 1e-3)
    assert torch.equal(kept, keep)
    for g, w, a, b in zip(got, first.masked_grad(keep), whole, driver.outputs()["train"]["first_grad"]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)
    assert any(float((g - w).abs().max()) > 1e-9 for g, w in zip(got, whole))


def test_first_step_leaves_out_grazing_and_moved_pixels(monkeypatch):
    """The reference's own renders leave out the grazing pixels alone;
    a pixel moved past EDGE in a render or the target goes too; past
    MASKED_MAX of the pixels the keep is None."""
    c = spec.resolve("sdf.train")
    monkeypatch.setattr(check, "MASKED_MAX", 1.0)
    first = check.FirstStep(c.config, c.traffic, 3, "cpu", W, H, 0.5)
    keep, counts = first.keep_of(first.a, first.b, first.target)
    assert keep.shape == (H, W, 1) and counts["branch"] == 0
    assert int((keep == 0).sum()) == counts["grazing"] == int(first.near.sum()) > 0
    none = check.FirstStep(c.config, c.traffic, 3, "cpu", W, H, 0.0)
    b = none.b.clone()
    b[0, 0, 1] += 2 * check.EDGE
    keep, counts = none.keep_of(none.a, b, none.target)
    assert counts == {"grazing": 0, "branch": 1} and float(keep[0, 0, 0]) == 0.0 and float(keep.sum()) == W * H - 1
    monkeypatch.setattr(check, "MASKED_MAX", 0.01)
    assert none.keep_of(none.a + 1.0, none.b, none.target)[0] is None


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_grazing_cosines_are_the_ports(seed):
    from pathtracer_tpu_torch.ops.megakernel_sdf import hit_cosines

    config = spec.resolve("sdf.frames").config
    key = next(gen.frame_keys(seed))
    got = grazing.hit_cosines(check.reference_scene(config, "cpu"), key, W, H)
    want = hit_cosines(port_scene(config["scene"]), key, W, H)[0]
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).any())


@pytest.mark.parametrize("cell", CONFIGS)
def test_work_counts_are_the_ports(cell):
    from pathtracer_tpu_torch.tools import work as port_work

    config = spec.resolve(cell).config
    key = next(gen.frame_keys(3))
    family = config["scene"]["family"]
    got = ref_work.count_work(check.reference_scene(config, "cpu"), family, key, W, H)
    port = port_scene(config["scene"])
    assert got["segments"] == port_work.count_segments(port, key, W, H)
    if family == "sdf":
        w = port_work.count_sdf_work(port, key, W, H)
        assert got["march_steps"] == w["closest_trips"] + w["shadow_trips"]


def test_select_and_replace_leaves():
    config = spec.resolve("analytical.train").config
    start = check.reference_scene(config, "cpu", key="start")
    names = ref_train.select(start, ["materials.rgb", "lights.emission"])
    assert names[0] == "params.materials.rgb.x" and names[-1] == "lights.emission.z" and len(names) == 6
    new = ref_train.replace_leaves(start, {"lights.emission.x": torch.tensor([9.0])})
    assert float(scenes.named_leaves(new)["lights.emission.x"][0]) == 9.0
    with pytest.raises(ValueError):
        ref_train.select(start, ["no_such_leaf"])
