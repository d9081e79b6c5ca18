"""The any hit and table gather probe kernels of `csrc/prof/` against
their twins on a CUDA card, at sizes the probes never use:

- the any hit (`anyhit.cu`): the tensor-core forms (3xTF32 and 6xTF32 on
  wgmma, 64-ray tasks on a persistent grid, 32 triangles a step) and
  the FP32 form, each within the reference's primitive gate (mismatch
  <= 0.2 %) of its twin, at R not a multiple of 64 and n_pad = 4 * 37
  (no multiple of the 32-triangle step);
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
from restir_tpu_torch.ops import intersect
from restir_tpu_torch.prof import kernels as pk
from restir_tpu_torch.prof import prof_fma
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
