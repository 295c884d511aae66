"""Camera: view/projection matrices and inverse-projection ray generation.

PyTorch port of `ptre_tpu/ops/camera.py`. Defaults mirror `camera.h:11,26-27`:
position (0, 0.5, -3), forward (0, -0.5, 3), vertical fov 45 deg, znear 0.01,
zfar 100. The pose leaves are small float32 tensors; width, height and
projection are plain ints.
"""

from __future__ import annotations

import dataclasses

import torch

from ptre_tpu_torch.ops import vecmat as vm

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


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
               zfar: float = 100.0, projection: int = PERSPECTIVE) -> "Camera":
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32)

        return cls(position=f32(position), forward=f32(forward),
                   fov_degrees=f32(fov_degrees), znear=f32(znear),
                   zfar=f32(zfar), width=width, height=height,
                   projection=projection)

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


def get_rays(cam: Camera, px, py, jitter):
    """World-space rays through pixel (px, py) + jitter (`camera.cu:20-43`):
    screen → NDC, unproject the near (z=0) and far (z=1) points through
    inv(proj) with w-divide, then inv(view); the ray runs near → far.

    px, py: (...,) pixel coordinates (x right, y down); jitter: (..., 2) in
    [-0.5, 0.5). Returns (origins, unit directions), (..., 3) each, on the
    device of ``px``: a camera of host tensors has its two 4x4 inverses made
    on the host and moved there.
    """
    inv_view = vm.inverse(cam.view_matrix()).to(px.device)
    inv_proj = vm.inverse(cam.projection_matrix()).to(px.device)

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
