"""Writes the JAX package's sharded results that tests/test_torch_parallel.py
and tests/test_torch_multihost.py hold the port to, into a directory:
`parallel_jax.npz` (render_frame_sharded's 32x16 frames of the float64
analytical scene on the 8-device mesh, 8x1 at spp 1 depth 4 and 4x2 at spp
4 depth 3, from PRNGKey(3); run_demo's final loss at its defaults, 64x32
and 4 steps; run_demo_ckpt's at 32x16 and 4 steps) and that run's
`mh_0002.npz`, the checkpoint a restart resumes from.

Run with the JAX package on a virtual 8-device CPU mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      PYTHONPATH=. python tests/torch_parallel_jax.py tests/golden_torch/parallel
"""

import os
import shutil
import sys
import tempfile

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import pathtracer_tpu as pt  # noqa: E402
from pathtracer_tpu.parallel import launch  # noqa: E402
from pathtracer_tpu.parallel.mesh import make_mesh, render_frame_sharded  # noqa: E402

# name -> (tiles, spp axis, spp, depth) of the sharded frames
FRAMES = {"sharded_8x1_spp1_d4": (8, 1, 1, 4), "sharded_4x2_spp4_d3": (4, 2, 4, 3)}


def main(out: str) -> None:
    assert len(jax.devices()) == 8, "needs the virtual 8-device CPU mesh"
    os.makedirs(out, exist_ok=True)
    results = {}
    for name, (tiles, n_spp, spp, depth) in FRAMES.items():
        scene = pt.make_analytical_scene(dtype=jnp.float64, recursion_depth=depth)
        img = render_frame_sharded(scene, jax.random.PRNGKey(3), make_mesh(tiles, n_spp), 32, 16, spp=spp)
        results[name] = np.asarray(img)
    results["run_demo_loss"] = np.asarray(launch.run_demo())
    with tempfile.TemporaryDirectory() as ckpt:
        results["run_demo_ckpt_loss"] = np.asarray(launch.run_demo_ckpt(width=32, height=16, steps=4, ckpt_dir=ckpt))
        shutil.copy(os.path.join(ckpt, "mh_0002.npz"), os.path.join(out, "mh_0002.npz"))
    np.savez(os.path.join(out, "parallel_jax.npz"), **results)


if __name__ == "__main__":
    main(sys.argv[1])
