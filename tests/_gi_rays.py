"""The rays a plain twin casts, recorded for the walk tests.

The plain twins test every triangle row through `ops.intersect_bf`:
`gi.gi_trace_ref` (kernel B8's twin) and the CPU route of the general
path's tracers (B11 / B12's twins). `cast_rays` patches the two entry
points of `intersect_bf` to record each call's rays, so the tests can
walk the same rays through the MTBVH (`ops/kernels/bvh_walk.py`) and
compare.
"""

from unittest import mock

from restir_tpu_torch.ops import intersect_bf as ibf
from restir_tpu_torch.ops.kernels import gi


def cast_rays(fn, *args, **kw):
    """The rays fn(*args, **kw) casts through `intersect_bf`, in order,
    and its result: (result, rays) with ("closest", o, d, active) for
    each brute-force closest hit and ("shadow", x, y, active) for each
    occlusion test ([R, 3] tensors and a bool [R] mask, or None for
    every lane)."""
    closest, occlusion = ibf.intersect_closest_bf, ibf.test_occlusion_bf
    rays, inside = [], []

    def record_closest(xform, o, d, active=None, chunk=ibf.CHUNK):
        if not inside:  # test_occlusion_bf's own closest hit is a shadow ray
            rays.append(("closest", o, d, active))
        return closest(xform, o, d, active, chunk)

    def record_occlusion(xform, x, y, active=None, chunk=ibf.CHUNK):
        rays.append(("shadow", x, y, active))
        inside.append(True)
        try:
            return occlusion(xform, x, y, active, chunk)
        finally:
            inside.pop()

    with mock.patch.object(ibf, "intersect_closest_bf", record_closest), \
            mock.patch.object(ibf, "test_occlusion_bf", record_occlusion):
        out = fn(*args, **kw)
    return out, rays


def gi_twin_rays(in_pack, looper, scene, **kw):
    """The rays B8's twin (`gi.gi_trace_ref`, keyword arguments `kw`)
    casts on `in_pack` and its trace pack: (go, rays) as `cast_rays`."""
    return cast_rays(gi.gi_trace_ref, in_pack, looper, scene, **kw)
