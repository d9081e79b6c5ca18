"""B10's plain version against `ris_cdf_pallas` (interpret mode).

The G-buffer comes from the JAX package's CPU G-buffer pass on
many_light_scene(8, 4) at 64x32 (2,048 pixels); both sides get the same
inputs. Gates of tests/test_pallas_kernels.py:177-231: the same light on
>= 99 % of shaded lanes, matched lanes' directions within rtol 1e-4,
cumulative weights within rtol 1e-3 on >= 99 %, M equal on every shaded
lane, and zero weight and M elsewhere.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.config import RenderConfig, TracerType, mat_flags
from restir_tpu.models import gbuffer as jgb
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import ris_kernel
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu.utils import math as jm
from restir_tpu_torch import convert
from restir_tpu_torch.ops.kernels import ris_cdf

W, H = 64, 32
LOOPER = 5


@pytest.fixture(scope="module")
def inputs():
    scene, camkw = many_light_scene(n_lights=8, n_blocks=4, bvh_impl="numpy")
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       aa_jitter=False, **mat_flags(scene))
    gb, it, mat, d = jgb.render_gbuffer(scene, cam, cam, cfg,
                                        jnp.uint32(LOOPER))
    wo = -d
    norm = jnp.where(((mat.type != 2) & (jm.dot(it.norm, wo) < 0))[..., None],
                     -it.norm, it.norm)
    shade = it.valid & (gb.prim_id != jgb.LIGHT_ID)
    args = dict(pos=it.pos, norm=norm, wo=wo, mtype=mat.type,
                metallic=mat.metallic, roughness=mat.roughness, shade=shade,
                prim_id=it.prim_id)
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, {k: np.array(v) for k, v in args.items()}


@pytest.mark.parametrize("single_sided", [True, False])
def test_ris_cdf_twin_matches_pallas(inputs, single_sided):
    scene, tscene, a = inputs
    want = ris_kernel.ris_cdf_pallas(
        *(jnp.asarray(a[k]) for k in ("pos", "norm", "wo", "mtype",
                                       "metallic", "roughness", "shade",
                                       "prim_id")),
        jnp.uint32(LOOPER), scene.light_verts, scene.light_normal,
        scene.light_radiance, scene.light_area, scene.light_center,
        scene.light_radius, scene.tri_xform, k=4, single_sided=single_sided,
        ctr_base=8, interpret=True)
    got = ris_cdf.ris_cdf(
        *(torch.as_tensor(a[k]) for k in ("pos", "norm", "wo", "mtype",
                                           "metallic", "roughness", "shade",
                                           "prim_id")),
        LOOPER, tscene.tables, tscene.bvh, k=4, single_sided=single_sided)
    li_w, wi_w, dist_w, w_w, m_w = (np.asarray(x) for x in want)
    li_g, wi_g, dist_g, w_g, m_g = (x.numpy() for x in got)
    shade = a["shade"]
    assert shade.mean() > 0.5
    same = (np.all(li_w == li_g, -1)
            & np.all(np.isclose(wi_w, wi_g, rtol=1e-4, atol=1e-5), -1))
    assert same[shade].mean() > 0.99, same[shade].mean()
    ok = same & shade
    np.testing.assert_allclose(wi_w[ok], wi_g[ok], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dist_w[ok], dist_g[ok], rtol=1e-4)
    agree = np.isclose(w_w[ok], w_g[ok], rtol=1e-3, atol=1e-6)
    assert agree.mean() > 0.99, agree.mean()
    assert (w_g[ok] > 0).mean() > 0.3  # live, visible winners
    assert (w_g[ok] == 0).mean() > 0.01  # and some occluded ones
    assert np.array_equal(m_w[shade], m_g[shade])
    assert np.all(w_g[~shade] == 0.0) and np.all(m_g[~shade] == 0)


def test_input_pack_layout(inputs):
    """The [14, R] pack puts every input in the TPU kernel's channel."""
    _, _, a = inputs
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    pack = ris_cdf.pack_inputs(t["pos"], t["norm"], t["wo"], t["mtype"],
                               t["metallic"], t["roughness"], t["shade"],
                               t["prim_id"])
    assert tuple(pack.shape) == (ris_cdf.CIN, W * H)
    assert torch.equal(pack[ris_cdf.IN_WO:ris_cdf.IN_WO + 3], t["wo"].T)
    assert torch.equal(pack[ris_cdf.IN_PRIM], t["prim_id"].float())
    assert torch.equal(pack[ris_cdf.IN_SHADE], t["shade"].float())
