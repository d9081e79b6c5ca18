"""The port's BSDFs against the JAX package's, on the CPU.

Lambertian, metallic-workflow GGX (with VNDF sampling) and dielectric:
eval, pdf and sample at the same inputs (made with numpy) agree within
rtol 1e-5 / atol 1e-6. Both sides run op by op, so they round alike.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.ops import bsdf as jb
from restir_tpu_torch.ops import bsdf as tb

N = 4096
TYPES = {"lambertian": 0, "metallic": 1, "dielectric": 2}


def _unit(g, n):
    v = g.standard_normal((n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=list(TYPES))
def inputs(request):
    g = np.random.default_rng(TYPES[request.param] + 11)
    n = _unit(g, N)
    wo = _unit(g, N)
    # most wo above the surface, a few grazing or below
    wo = np.where((np.sum(n * wo, -1, keepdims=True) < 0)
                  & (g.random((N, 1)) < 0.8), -wo, wo).astype(np.float32)
    wi = _unit(g, N)
    mat = dict(
        type=np.full(N, TYPES[request.param], np.int32),
        base_color=g.random((N, 3), dtype=np.float32),
        metallic=g.random(N, dtype=np.float32),
        roughness=(0.05 + 0.95 * g.random(N)).astype(np.float32),
        ior=(1.2 + 0.6 * g.random(N)).astype(np.float32))
    r3 = g.random((3, N), dtype=np.float32)
    jmat = jb.SurfaceMaterial(**{k: jnp.asarray(v) for k, v in mat.items()})
    tmat = tb.SurfaceMaterial(**{k: torch.as_tensor(v)
                                 for k, v in mat.items()})
    return request.param, (jmat, n, wo, wi, r3), (tmat, n, wo, wi, r3)


def _agree(want, got):
    """Per lane: every component within rtol 1e-5 / atol 1e-6."""
    ok = np.isclose(np.asarray(want), got.numpy(), rtol=1e-5, atol=1e-6,
                    equal_nan=True)
    return ok.reshape(ok.shape[0], -1).all(-1)


def _close(want, got, what, frac=1.0):
    ok = _agree(want, got)
    assert ok.mean() >= frac, (what, ok.mean(),
                               np.abs(np.asarray(want) - got.numpy()).max())


def test_eval_bsdf_agrees(inputs):
    _, (jm, n, wo, wi, _), (tm, *_) = inputs
    _close(jb.eval_bsdf(jm, *map(jnp.asarray, (n, wo, wi))),
           tb.eval_bsdf(tm, *map(torch.as_tensor, (n, wo, wi))), "eval")
    _close(jb.eval_bsdf_lum(jm, *map(jnp.asarray, (n, wo, wi))),
           tb.eval_bsdf_lum(tm, *map(torch.as_tensor, (n, wo, wi))),
           "eval_lum")


def test_pdf_bsdf_agrees(inputs):
    _, (jm, n, wo, wi, _), (tm, *_) = inputs
    _close(jb.pdf_bsdf(jm, *map(jnp.asarray, (n, wo, wi))),
           tb.pdf_bsdf(tm, *map(torch.as_tensor, (n, wo, wi))), "pdf")


def test_sample_bsdf_agrees(inputs):
    name, (jm, n, wo, _, r3), (tm, *_) = inputs
    want = jb.sample_bsdf(jm, jnp.asarray(n), jnp.asarray(wo),
                          tuple(jnp.asarray(r) for r in r3))
    got = tb.sample_bsdf(tm, torch.as_tensor(n), torch.as_tensor(wo),
                         tuple(torch.as_tensor(r) for r in r3))
    assert np.array_equal(np.asarray(want.type), got.type.numpy()), name
    assert np.array_equal(np.asarray(jb.is_delta(want.type)),
                          tb.is_delta(got.type).numpy())
    assert np.array_equal(np.asarray(jb.is_invalid(want.type)),
                          tb.is_invalid(got.type).numpy())
    # the GGX half vector's sampled direction amplifies an ulp of the
    # tangent frame (sin / cos of the disk sample differ by an ulp between
    # the two libraries) on a few lanes near the horizon: 0.1 % may miss
    _close(want.wi, got.wi, (name, "wi"), frac=0.999)
    # f and pdf agree to 1e-5 wherever the sampled direction is the same
    # and the two packages' eval / pdf agree on that same direction; where
    # GGX's D peaks sharply at low roughness an ulp of h turns into more
    # than 1e-5 even at equal inputs, which the evals at the JAX direction
    # show. Lanes outside that set are counted: at most 0.5 % miss 1e-5.
    jw = np.array(want.wi)
    args = (n, wo, jw)
    witness = (_agree(jb.eval_bsdf(jm, *map(jnp.asarray, args)),
                      tb.eval_bsdf(tm, *map(torch.as_tensor, args)))
               & _agree(jb.pdf_bsdf(jm, *map(jnp.asarray, args)),
                        tb.pdf_bsdf(tm, *map(torch.as_tensor, args))))
    held = np.all(jw == got.wi.numpy(), -1) & witness
    assert held.mean() >= 0.9, (name, held.mean())
    for field in ("f", "pdf"):
        ok = _agree(getattr(want, field), getattr(got, field))
        assert ok[held].all(), (name, field, (~ok[held]).sum())
        assert (~ok).sum() <= 0.005 * N, (name, field, (~ok).sum())
    if name != "lambertian":  # every lobe type draws a valid sample
        assert float((~tb.is_invalid(got.type)).float().mean()) > 0.3
