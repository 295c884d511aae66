"""Camera: view/projection matrices and inverse-projection ray generation.

PyTorch port of `ptre_tpu/ops/camera.py`. Defaults mirror `camera.h:11,26-27`:
position (0, 0.5, -3), forward (0, -0.5, 3), vertical fov 45 deg, znear 0.01,
zfar 100. The pose leaves are small float32 tensors on the camera's device
(the card unless the caller names another, as the reference's
``jnp.asarray`` places them on the accelerator); width, height and
projection are plain ints. Every consumer reads the camera where it lives
and none moves it: a camera on another device than the image raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ptre_tpu_torch.ops import vecmat as vm
from ptre_tpu_torch.utils.device import resolve

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
#: the camera's tensor leaves
_LEAVES = ("position", "forward", "fov_degrees", "znear", "zfar")


@dataclasses.dataclass
class Camera:
    """Pin-hole / orthographic camera (reference `camera.{h,cu}`)."""

    position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,) — not normalized; look_at normalizes
    fov_degrees: torch.Tensor  # () vertical fov
    znear: torch.Tensor  # ()
    zfar: torch.Tensor  # ()
    width: int = 1280
    height: int = 720
    projection: int = PERSPECTIVE

    @classmethod
    def create(cls, width: int = 1280, height: int = 720,
               position=(0.0, 0.5, -3.0), forward=(0.0, -0.5, 3.0),
               fov_degrees: float = 45.0, znear: float = 0.01,
               zfar: float = 100.0, projection: int = PERSPECTIVE,
               device=None) -> "Camera":
        """A camera whose pose leaves lie on ``device``: None means the card
        (RendererError where there is none), ``"cpu"`` the host."""
        device = resolve(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return cls(position=f32(position), forward=f32(forward),
                   fov_degrees=f32(fov_degrees), znear=f32(znear),
                   zfar=f32(zfar), width=width, height=height,
                   projection=projection)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        """This camera with its pose leaves on ``device`` (one copy each,
        none where they are there already)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _LEAVES})

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def view_matrix(self):
        """LH look_at view matrix (`camera.cu:11`)."""
        return vm.look_at(self.position, self.position + self.forward)

    def projection_matrix(self):
        """D3D z in [0, 1] projection (`camera.cu:12-13`)."""
        if self.projection == ORTHOGRAPHIC:
            return vm.orthographic(self.aspect, self.znear, self.zfar)
        return vm.perspective(self.aspect, vm.to_radians(self.fov_degrees),
                              self.znear, self.zfar)


#: (what, width, height, projection, leaf ids) -> (leaves, versions, value)
_DERIVED = {}
_DERIVED_KEEP = 16


def derived(cam: Camera, what: str, fn):
    """``fn(cam)``, made once and reused while the camera's leaves are the
    same tensors, unmodified (their version counters) and not differentiated
    (a leaf that needs a gradient with grad mode on makes it anew every
    call): the matrices and rows of a still camera cost a frame no launch.
    The value is shared: read it only."""
    leaves = tuple(getattr(cam, f) for f in _LEAVES)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return fn(cam)
    key = (what, cam.width, cam.height, cam.projection) + tuple(id(t) for t in leaves)
    versions = tuple(t._version for t in leaves)
    hit = _DERIVED.get(key)
    if hit is not None and hit[1] == versions and all(a is b for a, b in zip(hit[0], leaves)):
        return hit[2]
    value = fn(cam)
    _DERIVED.pop(key, None)
    _DERIVED[key] = (leaves, versions, value)
    while len(_DERIVED) > _DERIVED_KEEP:
        _DERIVED.pop(next(iter(_DERIVED)))
    return value


def check_device(cam: Camera, device, what: str = "the rays") -> None:
    """Raise unless the camera lies on ``device``: its consumers build its
    matrices where it lives, and a copy made every frame is what this
    refuses to hide (`Camera.to` moves it once)."""
    device = torch.device(device)
    if cam.device.type != device.type or (
            device.index is not None and cam.device.index not in (None, device.index)):
        raise ValueError(f"the camera is on {cam.device}, {what} on {device}: create it "
                         f"there (Camera.create(device=...)) or move it once (Camera.to)")


def get_rays(cam: Camera, px, py, jitter):
    """World-space rays through pixel (px, py) + jitter (`camera.cu:20-43`):
    screen → NDC, unproject the near (z=0) and far (z=1) points through
    inv(proj) with w-divide, then inv(view); the ray runs near → far.

    px, py: (...,) pixel coordinates (x right, y down); jitter: (..., 2) in
    [-0.5, 0.5). Returns (origins, unit directions), (..., 3) each. The
    camera's two 4x4 inverses are made on its device, which must be that of
    ``px`` (`check_device`), once for a still camera (`derived`).
    """
    check_device(cam, px.device)
    inv_view, inv_proj = derived(cam, "inverses", lambda c: (
        vm.inverse(c.view_matrix()), vm.inverse(c.projection_matrix())))

    x_ndc = ((px + jitter[..., 0]) / cam.width) * 2.0 - 1.0
    y_ndc = 1.0 - ((py + jitter[..., 1]) / cam.height) * 2.0
    zeros = torch.zeros_like(x_ndc)
    ndc_near = torch.stack([x_ndc, y_ndc, zeros], dim=-1)
    ndc_far = torch.stack([x_ndc, y_ndc, zeros + 1.0], dim=-1)

    view_near, w_near = vm.transform_points_h(ndc_near, inv_proj)
    view_far, w_far = vm.transform_points_h(ndc_far, inv_proj)
    world_near = vm.transform_points(view_near / w_near[..., None], inv_view)
    world_far = vm.transform_points(view_far / w_far[..., None], inv_view)
    return world_near, vm.normalize(world_far - world_near)
