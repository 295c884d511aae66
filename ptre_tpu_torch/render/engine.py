"""Engine facade: two swappable engines over one scene, frame loop.

PyTorch port of `ptre_tpu/render/engine.py` (the reference's
`IoniqRE/renderer.{h,cu}` dispatch layer), with the same behaviour:

  * two engines (PATHTRACER default, `renderer.cu:70-78`) behind one
    facade, toggled live; the switch is DEFERRED to the next frame boundary
    (`begin_frame`, `renderer.cu:45-53`) and drops the in-flight frame;
  * `reset()` is a pending flag applied at the start of the next
    path-traced frame (`path_tracer.h:65`);
  * scene edits mark the scene modified; both packets (the path tracer's
    and the rasterizer's ``spheres_as_triangles`` one) are rebuilt lazily on
    the renderer's device at the next frame, and accumulation is NOT reset
    on an edit (`application.cu:87-89`) unless ``config.reset_on_edit``;
  * `run()` renders a frame sequence to files in place of the swap chain.

Frame keys. Frame ``i`` is keyed ``k_i = fold(key_for(seed), i)`` (threefry,
`ops/rng`), as in the reference, and `render_step` takes ``k_i`` on every
route: the staged route draws exactly what the reference's staged route
draws (`pathtracer.py:151-159`), and the dense and wavefront routes, whose
kernels draw Philox, seed from ``pathtracer.fused_seed(k_i)``, the twin of
the reference's fused seed (`ptre_tpu/render/pathtracer.py:88`). Frame
``i``'s draws depend on (seed, i) alone, so a run checkpointed after frame
``k`` and resumed at frame index ``k`` draws what an uninterrupted run
draws.

Presentation (`engine.py:142-159` of the JAX package, "the host never
hard-syncs on the frame it just launched"). With ``present_async`` a
path-traced frame enqueues its `render_step` (which updates
``accum.linear`` in place) and `to_display`, copies the display tensor
``non_blocking`` into one of two pinned host buffers and records a CUDA
event after the copy; it then waits only on the previous frame's event and
returns a copy of that buffer, which the caller may keep. No device or
stream synchronize. The first frame returns zeros (the cleared
framebuffer, `path_tracer.cu:394-400`). Without ``present_async`` the frame
is returned synchronously. A raster frame converts on the device (clip,
x255, truncating uint8) and is returned synchronously, as in JAX.
"""

from __future__ import annotations

import enum
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ptre_tpu_torch.models.scene import Scene
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.render import pathtracer as pt
from ptre_tpu_torch.render import rasterizer as ras
from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig
from ptre_tpu_torch.utils.device import resolve
from ptre_tpu_torch.utils.image import write_image
from ptre_tpu_torch.utils.metrics import Metrics

class EngineKind(enum.IntEnum):
    RASTERIZER = 0
    PATHTRACER = 1  # default engine (`renderer.cu:70-78`)


class _PinnedFrames:
    """Two pinned host buffers for display frames on the card, used in
    turns: a frame is copied into one without blocking and an event is
    recorded after the copy, and reading it waits on that event alone."""

    def __init__(self, shape, device):
        self.device = device
        self.bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        self.events = [torch.cuda.Event() for _ in range(2)]
        self.slot = 0

    def stage(self, disp) -> Callable[[], np.ndarray]:
        """Enqueue the copy of ``disp``; returns the function that reads it."""
        slot, self.slot = self.slot, self.slot ^ 1
        self.bufs[slot].copy_(disp, non_blocking=True)
        self.events[slot].record(torch.cuda.current_stream(self.device))

        def collect() -> np.ndarray:
            self.events[slot].synchronize()
            return self.bufs[slot].numpy().copy()

        return collect


class Renderer:
    """Host-side frame-loop driver over the two engines, on ``device``
    (None: the card, RendererError where there is none; ``"cpu"`` runs the
    kernels' plain versions)."""

    def __init__(
        self,
        scene: Scene,
        camera: cam_ops.Camera,
        config: Optional[RenderConfig] = None,
        raster_config: Optional[RasterConfig] = None,
        engine: EngineKind = EngineKind.PATHTRACER,
        spp_per_frame: int = 1,
        ray_chunk: int = 0,
        row_chunk: int = 0,
        present_async: bool = True,
        device=None,
    ):
        self.device = resolve(device)
        self.scene = scene
        self.camera = camera.to(self.device)  # once: no frame copies it
        self.config = config or RenderConfig(width=camera.width, height=camera.height)
        self.raster_config = raster_config or RasterConfig(
            width=camera.width, height=camera.height
        )
        self._engine = engine
        self._pending_engine: Optional[EngineKind] = None
        self._pending_reset = False
        self.spp_per_frame = spp_per_frame
        self.ray_chunk = ray_chunk
        self.row_chunk = row_chunk

        self._pt_packet = None
        self._raster_packet = None
        self.accum = pt.AccumState.create(camera.height, camera.width, self.device)
        self._key = rng.key_for(self.config.seed)
        self._frame_index = 0
        self.metrics = Metrics()
        self.present_async = present_async
        #: reads the previous path-traced frame's display image (None: none)
        self._pending_disp: Optional[Callable[[], np.ndarray]] = None
        self._pinned: Optional[_PinnedFrames] = None

    # -- facade surface (`renderer.h:26-36`) --------------------------------
    @property
    def engine(self) -> EngineKind:
        return self._engine

    def toggle_engine(self):
        """Queue an engine switch for the next frame boundary (`renderer.cu:45-53`)."""
        target = (
            EngineKind.RASTERIZER
            if self._engine == EngineKind.PATHTRACER
            else EngineKind.PATHTRACER
        )
        self._pending_engine = target

    def set_engine(self, kind: EngineKind):
        self._pending_engine = kind

    def reset(self):
        """Queue an accumulation restart (`path_tracer.h:65` pending flag)."""
        self._pending_reset = True

    # -- frame loop ----------------------------------------------------------
    def begin_frame(self):
        if self._pending_engine is not None:
            if self._pending_engine != self._engine:
                self._pending_disp = None  # drop in-flight frame on switch
            self._engine = self._pending_engine
            self._pending_engine = None

    def _ensure_packets(self):
        if self.scene.modified() or self._pt_packet is None:
            self._pt_packet = self.scene.build_packet(device=self.device)
            self._raster_packet = self.scene.build_packet(spheres_as_triangles=True,
                                                          device=self.device)
            if self.config.reset_on_edit:
                self._pending_reset = True

    def _stage(self, disp) -> Callable[[], np.ndarray]:
        if disp.device.type != "cuda":
            return disp.numpy  # a fresh host tensor: nothing to wait for
        if self._pinned is None or tuple(self._pinned.bufs[0].shape) != tuple(disp.shape):
            self._pinned = _PinnedFrames(tuple(disp.shape), disp.device)
        return self._pinned.stage(disp)

    def draw_frame(self) -> np.ndarray:
        """Render one frame with the active engine → uint8 RGB (H, W, 3)."""
        self.begin_frame()
        self._ensure_packets()
        t0 = time.perf_counter()
        if self._engine == EngineKind.PATHTRACER:
            if self._pending_reset:
                self.accum = self.accum.reset()
                self._pending_reset = False
            self.accum = pt.render_step(
                self._pt_packet, self.camera, self.accum,
                rng.fold(self._key, self._frame_index), self.config,
                spp=self.spp_per_frame, ray_chunk=self.ray_chunk,
            )
            disp = pt.to_display(self.accum.linear, self.config.sqrt_gamma)
            if self.present_async:
                prev, self._pending_disp = self._pending_disp, self._stage(disp)
                if prev is None:
                    img = np.zeros((self.camera.height, self.camera.width, 3), np.uint8)
                else:
                    img = prev()
            else:
                img = disp.cpu().numpy()
            rays = (
                self.camera.width * self.camera.height
                * self.spp_per_frame * self.config.max_depth
            )
        else:
            with torch.no_grad():
                out = ras.rasterize(self._raster_packet, self.camera, self.raster_config,
                                    row_chunk=self.row_chunk)
            img = (torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
            rays = self.camera.width * self.camera.height
        self.metrics.frame(time.perf_counter() - t0, rays, self.accum.frame)
        self._frame_index += 1
        return img

    def flush(self) -> Optional[np.ndarray]:
        """Materialize and return the in-flight frame (None if none pending).
        The async analogue of the reference's final cudaDeviceSynchronize."""
        if self._pending_disp is None:
            return None
        img = self._pending_disp()
        self._pending_disp = None
        return img

    def run(
        self,
        frames: int,
        out_dir: Optional[str] = None,
        file_pattern: str = "frame_{:05d}.png",
        toggle_every: int = 0,
    ):
        """Render a frame sequence; optionally toggle engines periodically
        (the CLI stand-in for the reference's live `P` key)."""
        last = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        for i in range(frames):
            if toggle_every and i and i % toggle_every == 0:
                self.toggle_engine()
            last = self.draw_frame()
            if out_dir:
                write_image(os.path.join(out_dir, file_pattern.format(i)), last)
        return last
