"""Runtime configuration of the port: `RenderConfig` and `RasterConfig`.

The port's own copy of `ptre_tpu/utils/config.py`: the same fields,
defaults and checks, raising the port's `ConfigError`. The reference has no
config system — every knob is a compile-time constant (window 1280x720
`window.h:40-41`, RNG seed 1984 `path_tracer.cu:45`, max_depth 5 and t-range
`path_tracer.cu:240-241`, MSAA 4x `rasterizer.cu:31`, camera pose/fov
`camera.h:11,26-27`, materials `path_tracer.cu:248-249`); defaults reproduce
the reference. The route fields (``intersect_backend``, ``grad_sweep``)
and the rematerialisation fields (``remat_bounces``, ``remat_replay``) are
checked and read as the docstrings below say.
"""

from __future__ import annotations

import dataclasses

from ptre_tpu_torch.utils.errors import ConfigError


#: the values of RenderConfig.intersect_backend and RenderConfig.grad_sweep
INTERSECT_BACKENDS = ("auto", "xla", "pallas", "fused")
GRAD_SWEEPS = ("auto", "fused", "replay", "staged")


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
    #: the route of `render/pathtracer.render_step` and the staged sweep.
    #: "auto" and "fused": the fused kernels (dense render kernel or the
    #: wavefront) for every packet they take, else the staged route; the
    #: staged route's sweep is the sweep kernel on CUDA tensors, its plain
    #: version on CPU tensors. "pallas": the staged route for every packet,
    #: with that sweep. "xla": the staged route with the plain sweep, CPU
    #: tensors only (on the card it would be a hidden fallback with (R, T)
    #: temporaries): on CUDA tensors it raises ConfigError.
    intersect_backend: str = "auto"
    #: the route of DIFFERENTIABLE traces (`ops/integrator.trace`, the
    #: training steps): "auto" and "fused" take the fused recording forward
    #: and backward kernels for every packet `fused_grad.check_supported`
    #: takes, else the staged route (per-bounce sweep plus autograd);
    #: "staged" takes the staged route for every packet; "replay" (the
    #: reference's round-2 planar replay, kept for A/B checks of the fused
    #: route) takes the replay route (`path_replay.trace_fused_grad`: the
    #: dense recording kernel, then the replay kernels over gathered winner
    #: rows) for dense-class packets, else the staged route. The sweep is
    #: detached every way.
    grad_sweep: str = "auto"
    #: rematerialise in the training backward (`ops/gradsafe.remat`, the
    #: reference's `jax.checkpoint`): each sample of `train.mse_step` and of
    #: the sharded train and dual steps past one sample, and each bounce of
    #: the staged trace (`integrator.trace_staged`, its sweep winners passed
    #: in), are recomputed in the backward instead of kept. The values are
    #: the same bit for bit; the memory no longer grows with spp (without
    #: it, ~20 (R, 3) tensors a staged bounce and a sample's residuals on
    #: every route, for every sample), for one more forward a sample.
    remat_bounces: bool = True
    #: rematerialise each bounce of the plain replay chain
    #: (`path_replay.replay`, `path_replay.py:353`). Off by default, as in the
    #: reference. The replay route does not read it: its pair recomputes the
    #: chain inside the backward on both devices (on the card inside the
    #: backward kernel, as the TPU's does, `replay_kernel.py:18-22`; on the
    #: CPU its plain version), so no bounce's residuals outlive the forward.
    remat_replay: bool = False

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ConfigError(f"invalid resolution {self.width}x{self.height}")
        if self.max_depth < 1:
            raise ConfigError("max_depth must be >= 1")
        if self.samples_per_launch < 1:
            raise ConfigError("samples_per_launch must be >= 1")
        if self.intersect_backend not in INTERSECT_BACKENDS:
            raise ConfigError(f"intersect_backend must be one of {INTERSECT_BACKENDS}, "
                              f"got {self.intersect_backend!r}")
        if self.grad_sweep not in GRAD_SWEEPS:
            raise ConfigError(f"grad_sweep must be one of {GRAD_SWEEPS}, "
                              f"got {self.grad_sweep!r}")


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
