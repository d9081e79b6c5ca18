"""Stage probes of the port on the card: the counterparts of the TPU
probes in the repository's `prof/` directory that reach a Pallas kernel.

One module per probe file, under its name:

- `prof_gsplit`, `prof_gvariants`: B6's stages (const, raygen, hit, epi,
  full) from builds of `csrc/gbuffer_bvh.cu` with `-DPROBE_GBUF`;
- `prof_vissplit`: B7's and B10's shadow walks (full, search-only,
  fixed-node, no-leaf) from `-DPROBE_WALK` builds;
- `prof_hallsplit`: the hall frame's kernels and the host time between
  them, B7 with and without its early exit;
- `prof_gluesplit2`: the fused frame's host glue, piece by piece;
- `prof_take`, `prof_wavefront`: the coherence key, the hand-written
  radix sort and the permuted gather (`csrc/sort.cu`), and B13's
  any hit on sorted rays;
- `prof_union`: per-warp unions of the node rows B7's shadow rays visit;
- `prof_fma`: the brute-force any hit, FP32 FMA against tensor-core
  tiles (`csrc/prof/anyhit.cu`);
- `prof_gather`, `prof_v3`: table gathers and vec3 chains
  (`csrc/prof/mem.cu`).

    python -m restir_tpu_torch.prof <probe> [<probe> ...]   # or: all

Each module's `run(device="cuda", small=False)` prints its rows as
`probe <name> <variant>: <ms>` and returns them; on the card the times
are device ms by CUDA events. `device="cpu"` (with `small=True`, the
tests) runs the plain twins at a tiny size: its times are host times of
the CPU, and the stage builds, which exist only for the card, are left
out. The package imports torch and the port, never JAX.
"""

PROBES = ("prof_gsplit", "prof_gvariants", "prof_vissplit", "prof_hallsplit",
          "prof_gluesplit2", "prof_take", "prof_wavefront", "prof_union",
          "prof_fma", "prof_gather", "prof_v3")
