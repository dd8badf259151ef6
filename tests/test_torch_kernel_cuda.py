"""The CUDA megakernel against its plain PyTorch version, on the card.

Marked `cuda`: each test asks the `cuda_device` fixture for the card and
skips without one. This file imports no JAX; the JAX side is the committed
render tests/golden_torch/analytical_64x48_d4_k3.npy. Run on a CUDA host:
`python -m pytest tests/test_torch_kernel_cuda.py -q`.
"""

import os

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.integrator.tracer import FIXED, VERBATIM
from pathtracer_tpu_torch.models.analytical import make_scene
from pathtracer_tpu_torch.ops import megakernel as MK
from pathtracer_tpu_torch.ops import rng

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_torch", "analytical_64x48_d4_k3.npy")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megakernel has no CPU mode")
    return torch.device("cuda", 0)


def assert_image_close(img, ref):
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert np.quantile(diff, 0.999) < 1e-4
    assert diff.mean() < 1e-5


@pytest.mark.parametrize(
    "spp,quirks,seed", [(1, VERBATIM, 11), (2, VERBATIM, 12), (1, FIXED, 13)],
    ids=["spp1", "spp2", "fixed"],
)
def test_kernel_matches_plain_version(cuda_device, spp, quirks, seed):
    scene = make_scene(device=cuda_device)
    key = rng.prng_key(seed)
    launches = MK.render_frame_megakernel.launches
    img = MK.render_frame_megakernel(scene, key, 320, 240, spp, quirks)
    ref = MK.render_frame_reference(scene, key, 320, 240, spp, quirks)
    torch.cuda.synchronize()
    assert MK.render_frame_megakernel.launches == launches + 1
    assert img.shape == (240, 320, 4) and img.device == cuda_device
    assert_image_close(img.cpu(), ref.cpu())


def test_kernel_matches_jax_fixture(cuda_device):
    img = MK.render_frame_megakernel(make_scene(device=cuda_device), rng.prng_key(3), 64, 48)
    assert_image_close(img.cpu(), np.load(FIXTURE))


def test_kernel_refuses_float64(cuda_device):
    with pytest.raises(ValueError, match="float32"):
        MK.render_frame_megakernel(make_scene(dtype=torch.float64, device=cuda_device), rng.prng_key(0), 8, 8)
