"""Runtime configuration of the port: `RenderConfig` and `RasterConfig`.

The port's own copy of `ptre_tpu/utils/config.py`: the same fields,
defaults and checks, raising the port's `ConfigError`. The reference has no
config system — every knob is a compile-time constant (window 1280x720
`window.h:40-41`, RNG seed 1984 `path_tracer.cu:45`, max_depth 5 and t-range
`path_tracer.cu:240-241`, MSAA 4x `rasterizer.cu:31`, camera pose/fov
`camera.h:11,26-27`, materials `path_tracer.cu:248-249`); defaults reproduce
the reference. Fields that pick a JAX backend (``intersect_backend``,
``grad_sweep``, ``remat_*``) are carried so a configuration crosses between
the packages unchanged; the port's routes do not read them.
"""

from __future__ import annotations

import dataclasses

from ptre_tpu_torch.utils.errors import ConfigError


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Path-tracer + framebuffer configuration."""

    width: int = 1280  # `window.h:40`
    height: int = 720  # `window.h:41`
    samples_per_launch: int = 1  # 1 spp per kernel launch (`path_tracer.cu:402`)
    max_depth: int = 5  # `path_tracer.cu:240`
    t_min: float = 1e-6  # `path_tracer.cu:241`
    t_max: float = 999.99  # `path_tracer.cu:241`
    seed: int = 1984  # `path_tracer.cu:45`
    #: per-sample clamp to [0,1] before accumulation (`path_tracer.cu:345-348`)
    clamp_samples: bool = True
    #: sqrt display gamma (`path_tracer.cu:360-363`); False = linear output
    sqrt_gamma: bool = True
    #: sky gradient endpoints (`path_tracer.cu:307-316`)
    sky_bottom: tuple = (1.0, 1.0, 1.0)
    sky_top: tuple = (0.5, 0.7, 1.0)
    #: scattered-ray origin offset along the normal (`material.cu:11,16`)
    shadow_eps: float = 1e-4
    #: degenerate-pdf threshold (`material.cu:15`)
    pdf_eps: float = 1e-5
    #: Möller–Trumbore determinant epsilon (`shape.cu:72` via `iqmath.h:29`)
    det_eps: float = 1e-6
    #: auto-reset accumulation on scene edits. The reference does NOT reset
    #: (ghosting; manual right-click reset — `application.cu:87-89`), so the
    #: flag-compatible default is False.
    reset_on_edit: bool = False
    #: closest-hit sweep backend: "auto" (Pallas kernel on TPU, XLA
    #: elsewhere), "xla", or "pallas"
    intersect_backend: str = "auto"
    #: sweep backend for DIFFERENTIABLE traces (`integrator.trace`):
    #: "auto" (fully-fused custom-VJP path on TPU whenever the megakernel
    #: supports the scene — `ops.pallas.fused_grad`; staged per-bounce sweep
    #: elsewhere), "fused" (force the fused path), "replay" (round-2 planar
    #: replay, dense scenes only, kept for A/B), or "staged". The sweep is
    #: stop-gradient every way (detached visibility); "fused" keeps its
    #: O(R*P) cost AND the whole backward chain on-chip.
    grad_sweep: str = "auto"
    #: rematerialize the bounce body in the backward pass (`jax.checkpoint`).
    #: Without it, autodiff of the bounce scan stores every per-bounce
    #: intermediate — ~20 (R, 3) arrays per bounce, which at 1080p overflows
    #: a v5e chip's HBM; with it, only the small scan carry is saved and the
    #: bounce recomputes on the way back (the SURVEY §7 "re-intersect instead
    #: of storing hits" design). Identical values either way.
    remat_bounces: bool = True
    #: rematerialize the bounce body in the REPLAY backward (`ops.path_replay`).
    #: Off by default: the replay's residuals are O(R) per bounce (~40 MB per
    #: 1080p bounce), small enough to store, and measured on the v5e the
    #: unrolled no-remat replay is 1.45x faster fwd+bwd than the remat'd scan
    #: (83 ms vs 120 ms at 1080p; docs/PERF.md). The 64-spp sample scan keeps
    #: its own `jax.checkpoint` at the sample level regardless.
    remat_replay: bool = False

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ConfigError(f"invalid resolution {self.width}x{self.height}")
        if self.max_depth < 1:
            raise ConfigError("max_depth must be >= 1")
        if self.samples_per_launch < 1:
            raise ConfigError("samples_per_launch must be >= 1")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer configuration (reference `rasterizer.cu`)."""

    width: int = 1280
    height: int = 720
    #: supersampling factor per axis; 2 → 4 samples/pixel, the MSAA 4x
    #: analogue (`rasterizer.cu:31,36-37`; resolved by box filter like
    #: ResolveSubresource)
    supersample: int = 2
    #: clear color = sky blue (`renderer_base.cu:30`)
    clear_color: tuple = (0.62, 0.84, 1.0)
    #: back-face culling of clockwise-front primitives (`rasterizer.cu:117-124`)
    cull_backfaces: bool = True
    #: ambient term strength (pixel_shader.hlsl)
    ambient_strength: float = 0.2
    #: directional light dir, normalized at use (pixel_shader.hlsl)
    light_dir: tuple = (0.0, -1.0, 0.0)
    #: hard-coded red albedo (pixel_shader.hlsl)
    albedo: tuple = (1.0, 0.0, 0.0)

    def __post_init__(self):
        if self.supersample < 1:
            raise ConfigError("supersample must be >= 1")
