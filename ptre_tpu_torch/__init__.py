"""ptre_tpu_torch — the PyTorch + CUDA port of ``ptre_tpu`` for NVIDIA Hopper.

The JAX package ``ptre_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name and public layout so the parity
tests compare like with like. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` at first use (``ops/cuda/build.py``).

This package imports ``torch`` and never ``jax``, and no module of the JAX
package: it keeps its own copies of the mesh generators
(``models/mesh.py``), the configurations (``utils/config.py``) and the
error classes (``utils/errors.py``).

Layout:
  ops/       — math, Philox RNG, camera, integrator, gradsafe forms, replay
  ops/cuda/  — kernel wrappers, their plain PyTorch versions, the nvcc build
               (path tracer, wavefront, hard and soft rasterizer)
  csrc/      — the CUDA C++ sources
  models/    — meshes, scene graph, ScenePacket, demo scenes, the ctypes
               binding of the native C++ scene core
  parallel/  — the differentiable parameter set (multi-GPU still to come)
  render/    — progressive path tracer, rasterizer (hard and SoftRas),
               training steps, the engine facade (``Renderer``)
  app/       — headless window, input queues, timer, ``Application``
  utils/     — configs, errors, device checks, checkpoints, image IO,
               metrics, interop with the JAX package's pytrees
  cli.py     — ``python -m ptre_tpu_torch.cli render|bench|info``
"""

__version__ = "0.1.0"
