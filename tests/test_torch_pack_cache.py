"""A scene keeps its packed vector while nothing the packer reads changes.

`ops/megakernel.prepare_launch` packs a scene of a built-in family once
and hands the same vector to later launches (`packed_scene`), keyed on
every scene leaf's identity, version and grad flag, the frame's width and
height, the medium and the vector's own version. Through `prepare_launch`
on CPU scenes of the analytical and SDF families: an unchanged scene reuses
its vector; an in-place edit, a replaced leaf, another frame size or
medium, `scene.to(...)` and an in-place edit of the vector itself pack
again, bit-equal to a fresh scene's pack; a scene with a leaf that requires
grad packs every call, in either grad mode, and its vector carries the
graph; a plugin's scene (tests/torch_plugin_toy.py) packs every call; a
vector packed under `torch.inference_mode()` is not kept. The benchmark's
reader of `prepare_launch.packs` and `.pack_reuses` reads their share.
This file imports no JAX.
"""

from pathlib import Path

import pytest
import torch

import torch_plugin_toy as toy
from pathtracer_tpu_torch.integrator.tracer import VERBATIM
from pathtracer_tpu_torch.models import families
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng
from portbench import spec, tracing

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("analytical", "sdf")
W, H = 16, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prepare(scene, width=W, height=H, key=3):
    return MK.prepare_launch(scene, rng.prng_key(key), width, height, 1, VERBATIM)


def fresh_pack(family, edit=None, width=W, height=H, media=False):
    """The vector of a newly built scene of `family`, edited by `edit`."""
    scene = families.make_family_scene(family)
    if edit is not None:
        with torch.no_grad():
            edit(scene)
    return MK.BACKENDS[family].pack(scene, width, height, media).contiguous()


class Counts:
    """prepare_launch's packs and reuses since it was made."""

    def __init__(self):
        self.start = (MK.prepare_launch.packs, MK.prepare_launch.pack_reuses)

    def __call__(self):
        return MK.prepare_launch.packs - self.start[0], MK.prepare_launch.pack_reuses - self.start[1]


def grow_sphere(scene):
    scene.params.sphere_radius.add_(0.25)


@pytest.mark.parametrize("family", FAMILIES)
def test_an_unchanged_scene_reuses_its_vector(family):
    scene = families.make_family_scene(family)
    counts = Counts()
    first = prepare(scene)
    second = prepare(scene, key=4)
    assert second.sv is first.sv and counts() == (1, 1)
    assert torch.equal(second.sv, fresh_pack(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_an_in_place_edit_packs_again(family):
    scene = families.make_family_scene(family)
    old = prepare(scene).sv.clone()
    counts = Counts()
    with torch.no_grad():
        grow_sphere(scene)
    sv = prepare(scene).sv
    assert counts() == (1, 0) and not torch.equal(sv, old)
    assert torch.equal(sv, fresh_pack(family, grow_sphere))
    assert prepare(scene).sv is sv and counts() == (1, 1)


def replace_radius(scene):
    scene.params.sphere_radius = scene.params.sphere_radius.clone()


def round_trip(scene):
    scene.to(torch.float64).to(torch.float32)


CHANGES = {  # name: (the change, what packs the want: (width, height, media))
    "replaced_leaf": (replace_radius, (W, H, False)),
    "to": (round_trip, (W, H, False)),
    "width": (None, (W + 1, H, False)),
    "height": (None, (W, H + 2, False)),
    "medium": (None, (W, H, True)),
}


@pytest.mark.parametrize("change", list(CHANGES))
@pytest.mark.parametrize("family", FAMILIES)
def test_what_the_packer_reads_packs_again(family, change):
    edit, (width, height, media) = CHANGES[change]
    scene = families.make_family_scene(family)
    old = MK.packed_scene(scene, family, W, H, False)
    counts = Counts()
    if edit is not None:
        edit(scene)
    sv = MK.packed_scene(scene, family, width, height, media)
    assert sv is not old and counts() == (1, 0)
    assert torch.equal(sv, fresh_pack(family, width=width, height=height, media=media))


def test_a_new_scene_packs_again():
    scene = families.make_family_scene("analytical")
    prepare(scene)
    counts = Counts()
    moved = scene.replace()
    prepare(moved)
    prepare(moved)
    assert counts() == (1, 1)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_leaf_that_requires_grad_packs_every_call(family):
    scene = families.make_family_scene(family)
    kept = prepare(scene).sv
    scene.params.sphere_radius.requires_grad_()
    counts = Counts()
    first, second = prepare(scene).sv, prepare(scene).sv
    assert counts() == (2, 0)
    assert first.grad_fn is not None and second.grad_fn is not None and first is not second
    assert torch.equal(first.detach(), kept)
    with torch.no_grad():
        third, fourth = prepare(scene).sv, prepare(scene).sv
    assert counts() == (4, 0) and third is not fourth and not third.requires_grad
    scene.params.sphere_radius.requires_grad_(False)
    assert prepare(scene).sv is kept and counts() == (4, 1)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_scene_with_grad_leaves_keeps_nothing(family):
    scene = families.make_family_scene(family)
    scene.params.sphere_radius.requires_grad_()
    counts = Counts()
    with torch.no_grad():
        prepare(scene)
    prepare(scene)
    assert counts() == (2, 0) and getattr(scene, "_packed", None) is None


@pytest.mark.parametrize("family", FAMILIES)
def test_an_edit_of_the_vector_packs_again(family):
    scene = families.make_family_scene(family)
    sv = prepare(scene).sv
    sv.add_(1.0)
    counts = Counts()
    again = prepare(scene).sv
    assert again is not sv and counts() == (1, 0)
    assert torch.equal(again, fresh_pack(family))


def test_a_plugin_scene_packs_every_call():
    scene = toy.make_toy_scene()
    counts = Counts()
    first, second = prepare(scene).sv, prepare(scene).sv
    assert counts() == (2, 0) and first is not second and torch.equal(first, second)


def test_a_vector_packed_in_inference_mode_is_not_kept():
    scene = families.make_family_scene("analytical")
    counts = Counts()
    with torch.inference_mode():
        first, second = prepare(scene).sv, prepare(scene).sv
    assert counts() == (2, 0) and first is not second
    third = prepare(scene).sv
    assert not third.is_inference() and prepare(scene).sv is third and counts() == (3, 1)


def run_of(counters):
    return tracing.Run(None, 4, 1.0, tracing.Spans(), counters, None, [], {})


def test_the_reuse_share_reader():
    module = spec.reader(ROOT, "k1_pack_reuse_share.frames")
    reuses, packs = module.COUNTERS
    assert (reuses, packs) == ("pathtracer_tpu_torch.ops.megakernel:prepare_launch.pack_reuses",
                               "pathtracer_tpu_torch.ops.megakernel:prepare_launch.packs")
    assert all(isinstance(tracing.read_counter(p), int) for p in module.COUNTERS)
    assert module.read(run_of({reuses: 99, packs: 1})) == pytest.approx(99.0)
    assert module.read(run_of({reuses: 0, packs: 5})) == 0.0
    assert module.read(run_of({reuses: 0, packs: 0})) is None


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(MK.prepare_launch, "pack_reuses")
    module = spec.reader(ROOT, "k1_pack_reuse_share.frames")
    assert module.COUNTERS == () and module.read(run_of({})) is None
