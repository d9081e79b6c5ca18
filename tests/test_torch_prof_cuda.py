"""The any hit and table gather probe kernels of `csrc/prof/` against
their twins on a CUDA card, at sizes the probes never use:

- the any hit (`anyhit.cu`): the tensor-core forms (3xTF32 and 6xTF32 on
  wgmma, 64-ray tasks on a persistent grid, 32 triangles a step) and
  the FP32 form, each within the reference's primitive gate (mismatch
  <= 0.2 %) of its twin, at R not a multiple of 64 and n_pad = 4 * 37
  (no multiple of the 32-triangle step);
- the FP32 any hit (two rays a lane on a persistent grid fed by a queue
  of ray groups) equal bit for bit to the one-ray-a-lane build
  (`_build.VARIANTS["prof_ray1"]`) and within the gate of its twin, at R
  no multiple of the rays a lane x a block and n_pad = 4 and 512, with
  rays past their limit and zero padding rows;
- the vec3 chains in their three layouts equal to their twin bit for bit
  with the mask all 0, all 1 and mixed, at R that leaves a partial block;
- the table gather from shared memory (`mem.cu`: a grid the card holds
  at once, four lanes a thread and a scalar tail), bit for bit equal to
  index_select at K in {1, 1000, 8192, 58112} and R with a tail, beside
  the `__ldg` and texture forms; its refusal of a table over the
  232,448 bytes of shared memory a block can use (K = 58113) and of an
  index that is not 16-byte aligned.

These need nvcc and a GPU; without a card they skip (decided inside the
`cuda_device` fixture). The file imports no JAX, so on a card:

    python -m pytest tests/test_torch_prof_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from restir_tpu_torch import convert
from restir_tpu_torch.ops.kernels import _build
from restir_tpu_torch.ops import intersect
from restir_tpu_torch.prof import kernels as pk
from restir_tpu_torch.prof import prof_fma, prof_v3
from restir_tpu_torch.scene.procedural import many_light_scene

pytestmark = pytest.mark.cuda

GATE = prof_fma.GATE  # the reference's primitive gate


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def headline_xform(cuda_device):
    """The headline scene's tri_xform [4, 3N] and its bounding box."""
    arrays, _ = many_light_scene(64, 24)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    xform = intersect.traversal_arrays(scene, "brute").tri_xform
    v = arrays.verts.reshape(-1, 3)
    return xform, v.min(axis=0), v.max(axis=0)


@pytest.mark.parametrize("r,n_tri,n_pad", [(1, 37, 148), (31, 37, 148),
                                           (100003, 37, 148),
                                           (65557, 426, 512),
                                           (4099, 426, 1024)])
def test_anyhit_forms_within_the_gate_of_their_twins(cuda_device,
                                                     headline_xform, r,
                                                     n_tri, n_pad):
    xform, lo, hi = headline_xform
    planes = pk.plane_rows(xform[:, :3 * n_tri].contiguous(), n_pad)
    rays = prof_fma.random_rays(lo, hi, r, cuda_device, seed=r)
    got = {}
    for form in pk.ANYHIT_FORMS:
        got[form] = pk.anyhit(rays, planes, form)
        want = pk.anyhit_ref(rays, planes,
                             split=None if form == "fma" else int(form[3]))
        assert got[form].shape == (r,) and got[form].dtype == torch.bool
        assert (got[form] != want).float().mean().item() <= GATE, form
        # the same flags on a second launch (no state left between)
        assert torch.equal(pk.anyhit(rays, planes, form), got[form])
    assert (got["mma6"] != got["fma"]).float().mean().item() <= GATE
    if r > 1000:
        assert 0.05 < got["fma"].float().mean().item() < 0.95


def test_anyhit_rays_past_the_limit_and_padding_rows(cuda_device,
                                                     headline_xform):
    """Rays with limit 0 hit nothing; zero plane rows never hit."""
    xform, lo, hi = headline_xform
    r = 4099
    rays = prof_fma.random_rays(lo, hi, r, cuda_device, seed=3)
    planes = pk.plane_rows(xform[:, :3 * 37].contiguous(), 148)
    rays[6] = 0.0
    for form in pk.ANYHIT_FORMS:
        assert not pk.anyhit(rays, planes, form).any(), form
    zero = torch.zeros((148, 12), device=cuda_device)
    rays = prof_fma.random_rays(lo, hi, r, cuda_device, seed=4)
    for form in pk.ANYHIT_FORMS:
        assert not pk.anyhit(rays, zero, form).any(), form


def one_ray_a_lane(rays, planes):
    """The FP32 any hit's flags from the one-ray-a-lane build."""
    occ = torch.empty(rays.shape[1], dtype=torch.uint8, device=rays.device)
    lib = _build.variant_library("prof_ray1")
    err = lib.restir_prof_anyhit(_build.ptr(rays), _build.ptr(planes),
                                 planes.shape[0], rays.shape[1], 0,
                                 _build.ptr(occ),
                                 _build.stream_of(rays.device))
    _build.check(err, "restir_prof_anyhit (prof_ray1)")
    return occ.bool()


@pytest.mark.parametrize("r", [1, 33, 1000, 262147, 2073601])
@pytest.mark.parametrize("n_tri,n_pad", [(1, 4), (3, 4), (426, 512),
                                         (300, 512)])
def test_anyhit_fma_equals_the_one_ray_build(cuda_device, headline_xform, r,
                                             n_tri, n_pad):
    xform, lo, hi = headline_xform
    planes = pk.plane_rows(xform[:, :3 * n_tri].contiguous(), n_pad)
    rays = prof_fma.random_rays(lo, hi, r, cuda_device, seed=r + n_tri)
    rays[6, 0::7] = 0.0  # past their limit at any t > 0
    rays[6, 3::7] = -1.0
    got = pk.anyhit(rays, planes, "fma")
    assert torch.equal(got, one_ray_a_lane(rays, planes))
    assert not got[0::7].any() and not got[3::7].any()
    want = pk.anyhit_ref(rays, planes)
    assert (got != want).float().mean().item() <= GATE
    if r > 1000 and n_tri > 100:
        assert 0.05 < got.float().mean().item() < 0.95


@pytest.mark.parametrize("mask", ["zeros", "ones", "mixed"])
@pytest.mark.parametrize("r", [1, 255, 1000003])
def test_chain_layouts_equal_the_twin(cuda_device, mask, r):
    pack = prof_v3.pack(r, cuda_device, seed=r)
    if mask != "mixed":
        pack[6] = 0.0 if mask == "zeros" else 1.0
    want = pk.chain_ref(pack)
    if mask == "zeros":
        assert torch.equal(want, pack[0:3])
    for layout in pk.CHAIN_LAYOUTS:
        got = pk.chain(pack, layout)
        assert got.shape == (3, r)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            layout


def test_anyhit_refuses_rows_over_shared_memory(cuda_device,
                                                headline_xform):
    xform, lo, hi = headline_xform
    rays = prof_fma.random_rays(lo, hi, 1000, cuda_device, seed=1)
    for form, fits in (("mma3", 2400), ("mma6", 1600)):
        planes = pk.plane_rows(xform, fits + 32)
        with pytest.raises(ValueError, match="232448 bytes"):
            pk.anyhit(rays, planes, form)
        planes = pk.plane_rows(xform, fits)
        want = pk.anyhit_ref(rays, planes, split=int(form[3]))
        got = pk.anyhit(rays, planes, form)
        assert (got != want).float().mean().item() <= GATE


@pytest.mark.parametrize("k", [1, 1000, 8192, 58112])
@pytest.mark.parametrize("r", [1, 3, 4093, 1920 * 1088 + 3])
def test_table_gather_equals_index_select(cuda_device, k, r):
    g = np.random.default_rng(k + r)
    table = torch.tensor(g.normal(size=k).astype(np.float32),
                         device=cuda_device)
    for idx in (pk.gather_index(r, k, cuda_device),
                torch.tensor(g.integers(0, k, size=r).astype(np.int32),
                             device=cuda_device)):
        want = table.index_select(0, idx.long())
        assert torch.equal(pk.table_gather(table, idx, "shared"), want)
        assert torch.equal(pk.table_gather(table, idx, "ldg"), want)
        tex = pk.texture(table)
        try:
            assert torch.equal(pk.table_gather(table, idx, "tex", tex=tex),
                               want)
        finally:
            torch.cuda.synchronize()
            pk.free_texture(tex)


def test_table_gather_from_a_misaligned_table(cuda_device):
    """A table view 4 bytes into its storage stages without float4s."""
    base = torch.arange(8193, dtype=torch.float32, device=cuda_device)
    table = base[1:]
    idx = pk.gather_index(70001, 8192, cuda_device)
    assert torch.equal(pk.table_gather(table, idx, "shared"),
                       table.index_select(0, idx.long()))


def test_table_gather_refusals(cuda_device):
    idx = pk.gather_index(1000, 58113, cuda_device)
    table = torch.zeros(58113, device=cuda_device)
    with pytest.raises(ValueError, match="232448 bytes"):
        pk.table_gather(table, idx, "shared")
    # the other forms take any table
    assert torch.equal(pk.table_gather(table, idx, "ldg"),
                       torch.zeros(1000, device=cuda_device))
    base = pk.gather_index(1001, 1024, cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.table_gather(torch.zeros(1024, device=cuda_device), base[1:],
                        "shared")
