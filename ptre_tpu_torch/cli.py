"""Command-line interface: render frame sequences to files.

The port's counterpart of `ptre_tpu/cli.py`, with the same subcommands and
flags plus ``--device {cuda,cpu}`` (default ``cuda``; no fallback: without
a card ``cuda`` raises RendererError). The `P`-key engine toggle is
``--engine/--toggle-every``, the right-mouse accumulation reset
``--reset-every``, the FPS title bar a logged metrics summary, and the swap
chain PNG/PPM/NPY frame sequences.

Usage:
  python -m ptre_tpu_torch.cli render --scene demo --width 640 --height 360 \\
      --frames 8 --spp 4 --out /tmp/frames
  python -m ptre_tpu_torch.cli render --engine raster --out /tmp/frames
  python -m ptre_tpu_torch.cli render --device cpu --width 64 --height 36
  python -m ptre_tpu_torch.cli bench --width 1920 --height 1080
  python -m ptre_tpu_torch.cli info
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import rng
from ptre_tpu_torch.render.engine import EngineKind, Renderer
from ptre_tpu_torch.utils import checkpoint as ckpt
from ptre_tpu_torch.utils.config import RasterConfig, RenderConfig
from ptre_tpu_torch.utils.device import card_name_and_power_limit, resolve
from ptre_tpu_torch.utils.errors import RendererError
from ptre_tpu_torch.utils.image import write_image
from ptre_tpu_torch.utils.metrics import configure_logging, logger

SCENES = {
    "demo": demo.reference_demo_scene,
    "sphere-light": demo.sphere_light_scene,
    "cornell": demo.cornell_spheres_scene,
}
DEVICES = ("cuda", "cpu")
#: bench.py's forward reference: 1280*720 samples per 0.1 s x 5 bounces
BASELINE_MRAYS = 1280 * 720 * 10 * 5 / 1e6
SPP_BENCH, SPP_TRAIN, STEPS = 4, 64, 8  # bench.py's defaults


def _build_renderer(args) -> Renderer:
    scene = SCENES[args.scene]()
    dev = _device(args)
    cam = cam_ops.Camera.create(
        width=args.width,
        height=args.height,
        projection=cam_ops.ORTHOGRAPHIC if args.orthographic else cam_ops.PERSPECTIVE,
        device=dev,
    )
    cfg = RenderConfig(
        width=args.width, height=args.height, max_depth=args.max_depth,
        seed=args.seed,
    )
    engine = EngineKind.RASTERIZER if args.engine == "raster" else EngineKind.PATHTRACER
    return Renderer(
        scene, cam, cfg,
        RasterConfig(width=args.width, height=args.height),
        engine=engine, spp_per_frame=args.spp, ray_chunk=args.ray_chunk,
        device=dev,
    )


def cmd_render(args) -> int:
    r = _build_renderer(args)
    if args.resume and os.path.exists(args.resume):
        accum, _, frame_index, _ = ckpt.load_render_state(args.resume, r.device)
        r.accum, r._frame_index = accum, frame_index
        logger.info("resumed from %s at %d samples", args.resume, accum.frame)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(args.frames):
        if args.toggle_every and i and i % args.toggle_every == 0:
            r.toggle_engine()
        if args.reset_every and i and i % args.reset_every == 0:
            r.reset()
        img = r.draw_frame()
        write_image(os.path.join(args.out, f"frame_{i:05d}.{args.format}"), img)
        if args.checkpoint:
            ckpt.save_render_state(args.checkpoint, r.accum, args.seed, r._frame_index)
    logger.info(
        "%d frames in %.2fs | %s", args.frames, time.perf_counter() - t0,
        r.metrics.summary(),
    )
    return 0


def _device(args) -> torch.device:
    """The device ``--device`` names: ``cuda`` is the card
    (`utils.device.resolve`, RendererError where there is none)."""
    return resolve(None if args.device == "cuda" else args.device)


def _device_entry(dev: torch.device) -> dict:
    """{"name", "power_limit"} of the device a measurement ran on."""
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    card = card_name_and_power_limit()
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit": None if card is None else card[1]}


def _bench_forward(dev, W, H, steps):
    """render_step Mrays/s on the demo scene, spp 4, 1 warm-up + ``steps``
    timed steps keyed as the engine keys its frames."""
    from ptre_tpu_torch.render import pathtracer as pt

    pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H, device=dev)
    cfg = RenderConfig(width=W, height=H)
    key = rng.key_for(cfg.seed)
    accum = pt.render_step(pkt, cam, pt.AccumState.create(H, W, dev), rng.fold(key, 0), cfg,
                           spp=SPP_BENCH)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        accum = pt.render_step(pkt, cam, accum, rng.fold(key, i), cfg, spp=SPP_BENCH)
    _sync(dev)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(accum.linear).all()):
        raise RendererError(f"non-finite image at {W}x{H}")
    return W * H * SPP_BENCH * steps * cfg.max_depth / dt / 1e6


def _bench_fwdbwd(dev, W, H, steps):
    """Forward+backward Mrays/s of `mse_step` at spp 1 (1 warm-up +
    ``steps`` timed steps) and of one `two_pass_mse_step` at spp 64 after
    its warm-up, target zeros; every gradient leaf must be finite."""
    from ptre_tpu_torch.parallel import sharding as sh
    from ptre_tpu_torch.render import train

    pkt = demo.reference_demo_scene(32, 16).build_packet(device=dev)
    cam = cam_ops.Camera.create(width=W, height=H, device=dev)
    cfg = RenderConfig(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    target = torch.zeros((W * H, 3), dtype=torch.float32, device=dev)

    def checked(step, what):
        loss, grads = step
        for k, g in grads.items():
            if not bool(torch.isfinite(g).all()):
                raise RendererError(f"non-finite gradient {k!r} at {W}x{H} {what}")
        return loss

    checked(train.mse_step(params, pkt, cam, target, cfg, 1, spp=1), "spp 1")
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(2, steps + 2):
        step = train.mse_step(params, pkt, cam, target, cfg, i, spp=1)
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    checked(step, "spp 1")
    checked(train.two_pass_mse_step(params, pkt, cam, target, cfg, 0x64, spp=SPP_TRAIN),
            f"spp {SPP_TRAIN}")
    _sync(dev)
    t0 = time.perf_counter()
    step = train.two_pass_mse_step(params, pkt, cam, target, cfg, 0x65, spp=SPP_TRAIN)
    _sync(dev)
    t64 = time.perf_counter() - t0
    checked(step, f"spp {SPP_TRAIN}")
    rays = W * H * cfg.max_depth
    return rays / dt / 1e6, rays * SPP_TRAIN / t64 / 1e6


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_bench(args) -> int:
    """The counterpart of `bench.main`'s default measurement at
    ``--width/--height``, host clock around steps that end in a
    synchronize; prints bench.py's JSON keys plus the device. Writes no
    file."""
    dev = _device(args)
    W, H = args.width, args.height
    fwd = _bench_forward(dev, W, H, STEPS)
    fb, fb64 = _bench_fwdbwd(dev, W, H, STEPS)
    print(json.dumps({
        "metric": f"pathtrace_{H}p_mrays_per_s",
        "value": fwd,
        "unit": "Mrays/s",
        "vs_baseline": fwd / BASELINE_MRAYS,
        "extra": {"fwdbwd_mrays_per_s": fb, "fwdbwd_64spp_step_mrays_per_s": fb64},
        "device": _device_entry(dev),
    }), flush=True)
    return 0


def cmd_info(args) -> int:
    dev = _device(args)
    info = {
        "backend": dev.type,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if dev.type == "cuda" else ["cpu"]),
        "scenes": sorted(SCENES),
    }
    card = card_name_and_power_limit() if torch.cuda.is_available() else None
    if card is not None:
        info["card"] = {"name": card[0], "power_limit": card[1]}
    print(json.dumps(info, indent=2), flush=True)
    return 0


def main(argv=None) -> int:
    configure_logging()
    p = argparse.ArgumentParser(prog="ptre_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(parser):
        parser.add_argument("--device", choices=DEVICES, default="cuda",
                            help="where to run (no fallback: cuda needs a card)")

    pr = sub.add_parser("render", help="render a frame sequence")
    pr.add_argument("--scene", choices=sorted(SCENES), default="demo")
    pr.add_argument("--engine", choices=["pt", "raster"], default="pt")
    pr.add_argument("--width", type=int, default=1280)
    pr.add_argument("--height", type=int, default=720)
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--spp", type=int, default=1, help="samples per frame")
    pr.add_argument("--max-depth", type=int, default=5)
    pr.add_argument("--seed", type=int, default=1984)
    pr.add_argument("--ray-chunk", type=int, default=0)
    pr.add_argument("--orthographic", action="store_true")
    pr.add_argument("--toggle-every", type=int, default=0,
                    help="toggle engine every N frames (the 'P' key)")
    pr.add_argument("--reset-every", type=int, default=0,
                    help="reset accumulation every N frames (right mouse)")
    pr.add_argument("--out", default="frames")
    pr.add_argument("--format", choices=["png", "ppm", "npy"], default="png")
    pr.add_argument("--checkpoint", default=None, help="save state here each frame")
    pr.add_argument("--resume", default=None, help="load state from checkpoint")
    device_flag(pr)
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="run the standard measurement")
    pb.add_argument("--width", type=int, default=1920)
    pb.add_argument("--height", type=int, default=1080)
    device_flag(pb)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="print backend/devices/scenes")
    device_flag(pi)
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
