"""The differentiable parameter set of a scene and camera.

Port of the two parameter functions of `ptre_tpu/parallel/sharding.py`
(:198-230). The rest of that module — sharded render and train steps over a
device mesh — waits for the multi-GPU slice (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses

#: the parameter keys, in the reference's order
PARAM_KEYS = ("transforms", "sph_center", "sph_radius", "mat_albedo", "mat_param",
              "sky_bottom", "sky_top", "cam_position", "cam_forward", "cam_fov")


def differentiable_params(packet, cam):
    """The sweepable / differentiable parameters: a dict of the packet's and
    the camera's float leaves. The camera's leaves are moved to the packet's
    device, where the rays are made."""
    dev = packet.device
    return {
        "transforms": packet.transforms,
        "sph_center": packet.sph_center,
        "sph_radius": packet.sph_radius,
        "mat_albedo": packet.mat_albedo,
        "mat_param": packet.mat_param,
        "sky_bottom": packet.sky_bottom,
        "sky_top": packet.sky_top,
        "cam_position": cam.position.to(dev),
        "cam_forward": cam.forward.to(dev),
        "cam_fov": cam.fov_degrees.to(dev),
    }


def apply_params(params, packet, cam):
    """(packet, camera) with the parameter leaves put in place; the camera's
    other leaves follow the parameters' device."""
    packet = dataclasses.replace(
        packet,
        transforms=params["transforms"],
        sph_center=params["sph_center"],
        sph_radius=params["sph_radius"],
        mat_albedo=params["mat_albedo"],
        mat_param=params["mat_param"],
        sky_bottom=params["sky_bottom"],
        sky_top=params["sky_top"],
    )
    dev = params["cam_position"].device
    cam = dataclasses.replace(
        cam,
        position=params["cam_position"],
        forward=params["cam_forward"],
        fov_degrees=params["cam_fov"],
        znear=cam.znear.to(dev),
        zfar=cam.zfar.to(dev),
    )
    return packet, cam
