"""Training past the fused kernels' depth cap takes the staged route.

The recording, fused backward and replay kernels keep per-bounce state for
at most `megakernel.MAX_DEPTH` (8) bounces. `integrator.grad_route` sends
any deeper trace to "staged" under every ``grad_sweep``, from the config and
the packet alone, so the CPU and the card take the same route, as the
reference's ``fits(packet, max_depth)`` gate sends a packet whose backward
does not fit (`ptre_tpu/ops/pallas/fused_grad.py:69-83`). At max_depth 8 the
routes are those of every shallower trace: "fused" under "auto" and
"fused", "replay" for a dense-class packet under "replay" (a triangle-scale
packet has no replay route and takes "staged").

Against the JAX package, which runs the staged route on the CPU: the same
threefry key on both sides (`rng.Key`, the bit-exact twin), tolerances of
`tests/test_torch_staged.py`: colour and loss within rtol 1e-5 (atol 1e-5
on the colour), every gradient leaf within 5e-4 relative L2 (the same
formulas rounded in another order; rays near the gradsafe floors amplify
rounding, ROADMAP C2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptre_tpu.models import demo as jdemo
from ptre_tpu.ops import camera as jcam
from ptre_tpu.ops import rng as jrng
from ptre_tpu.parallel import sharding as jsh
from ptre_tpu.render import train as jtrain
from ptre_tpu.utils.config import RenderConfig as JConfig
from ptre_tpu_torch.models import demo
from ptre_tpu_torch.ops import camera as cam_ops
from ptre_tpu_torch.ops import integrator
from ptre_tpu_torch.ops.cuda import megakernel as mk
from ptre_tpu_torch.parallel import sharding as sh
from ptre_tpu_torch.render import train
from ptre_tpu_torch.utils import interop
from ptre_tpu_torch.utils.config import RenderConfig

W, H = 16, 8
DEEP = mk.MAX_DEPTH + 1
PACKETS = {"demo": lambda: demo.reference_demo_scene(8, 4).build_packet(device="cpu"),
           "wavefront": lambda: demo.config4_mixed_scene(12, 6).build_packet(device="cpu")}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("sweep", ["auto", "fused", "replay"])
@pytest.mark.parametrize("kind", list(PACKETS))
def test_grad_route_past_max_depth_is_staged(kind, sweep):
    pkt = PACKETS[kind]()
    assert mk.dense_supported(pkt) == (kind == "demo")
    deep = RenderConfig(width=W, height=H, max_depth=DEEP, grad_sweep=sweep)
    at_cap = RenderConfig(width=W, height=H, max_depth=mk.MAX_DEPTH, grad_sweep=sweep)
    assert integrator.grad_route(deep, pkt) == "staged"
    want = {"auto": "fused", "fused": "fused",
            "replay": "replay" if kind == "demo" else "staged"}[sweep]
    assert integrator.grad_route(at_cap, pkt) == want
    # the staged route has a sweep on either device: nothing to refuse
    for device in ("cpu", "cuda"):
        integrator.check_grad_dispatch(pkt, device, deep)


@pytest.fixture(scope="module")
def jax_deep_step():
    """The JAX package's depth-9 step on the demo (staged on the CPU)."""
    jp = jdemo.reference_demo_scene(8, 4).build_packet()
    jc = jcam.Camera.create(width=W, height=H)
    jcfg = JConfig(width=W, height=H, max_depth=DEEP, remat_bounces=False)
    target = np.random.default_rng(0).uniform(0, 0.5, (W * H, 3)).astype(np.float32)
    key = jrng.key_for(3)
    jparams = jsh.differentiable_params(jp, jc)
    loss, grads = jtrain.mse_step(jparams, jp, jc, jnp.asarray(target), key, jcfg, spp=2)
    color = jtrain.sample_color(jparams, jp, jc, jcfg, jrng.fold(key, 0))
    return target, key, float(loss), {k: np.asarray(v) for k, v in grads.items()}, \
        np.asarray(color)


@pytest.mark.parametrize("sweep", ["auto", "fused", "replay"])
def test_mse_step_past_max_depth_matches_jax(jax_deep_step, sweep):
    torch.set_num_threads(1)
    target, key, jloss, jgrads, jcolor = jax_deep_step
    pkt = PACKETS["demo"]()
    cam = cam_ops.Camera.create(width=W, height=H, device="cpu")
    cfg = RenderConfig(width=W, height=H, max_depth=DEEP, grad_sweep=sweep)
    tkey = interop.key_from_jax(np.asarray(key))
    params = sh.differentiable_params(pkt, cam)
    color = train.sample_color(params, pkt, cam, cfg, tkey, 0)
    np.testing.assert_allclose(color.detach().numpy(), jcolor, rtol=1e-5, atol=1e-5)
    loss, grads = train.mse_step(params, pkt, cam, torch.from_numpy(target), cfg, seed=tkey,
                                 spp=2)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        assert _rel(jgrads[k], g.numpy()) <= 5e-4, (k, _rel(jgrads[k], g.numpy()))
    for k in ("mat_albedo", "sph_radius", "cam_position"):
        assert float(np.abs(jgrads[k]).max()) > 0, k
