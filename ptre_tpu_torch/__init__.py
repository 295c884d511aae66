"""ptre_tpu_torch — the PyTorch + CUDA port of ``ptre_tpu`` for NVIDIA Hopper.

The JAX package ``ptre_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name and public layout so the parity
tests compare like with like. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` at first use (``ops/cuda/build.py``).

This package imports ``torch`` and never ``jax``. From the reference it
reuses only the jax-free modules: ``models.mesh``, ``utils.config``,
``utils.errors`` and ``utils.image``.

Layout:
  ops/       — math, Philox RNG, camera, integrator, gradsafe forms, replay
  ops/cuda/  — kernel wrappers, their plain PyTorch versions, the nvcc build
  csrc/      — the CUDA C++ sources
  models/    — scene graph, ScenePacket, demo scenes
  parallel/  — the differentiable parameter set (multi-GPU still to come)
  render/    — progressive path tracer frame pipeline, training steps
  utils/     — device checks, interop with the JAX package's pytrees
"""

__version__ = "0.1.0"
