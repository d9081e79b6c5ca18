// The vec3 chain's factors (csrc/prof/mem.cu): c_i = float32(0.5 + i *
// 1e-3), i = 0 .. 89, as numpy computes them (a rounded double product, a
// rounded double sum, then the nearest float32), written as hex floats so
// that no compiler rounds them again. tests/test_torch_prof.py holds them
// to numpy's values bit for bit.
#pragma once

namespace restir_prof {

constexpr int kChainRounds = 90;

// c_i; with i a constant (an unrolled round loop) the load folds into the
// multiply's immediate operand.
__device__ __forceinline__ float chain_factor(int i) {
  constexpr float c[kChainRounds] = {
      0x1p-1f, 0x1.008312p-1f, 0x1.010624p-1f, 0x1.018938p-1f,
      0x1.020c4ap-1f, 0x1.028f5cp-1f, 0x1.03126ep-1f, 0x1.039582p-1f,
      0x1.041894p-1f, 0x1.049ba6p-1f, 0x1.051eb8p-1f, 0x1.05a1cap-1f,
      0x1.0624dep-1f, 0x1.06a7fp-1f, 0x1.072b02p-1f, 0x1.07ae14p-1f,
      0x1.083126p-1f, 0x1.08b43ap-1f, 0x1.09374cp-1f, 0x1.09ba5ep-1f,
      0x1.0a3d7p-1f, 0x1.0ac084p-1f, 0x1.0b4396p-1f, 0x1.0bc6a8p-1f,
      0x1.0c49bap-1f, 0x1.0cccccp-1f, 0x1.0d4fep-1f, 0x1.0dd2f2p-1f,
      0x1.0e5604p-1f, 0x1.0ed916p-1f, 0x1.0f5c28p-1f, 0x1.0fdf3cp-1f,
      0x1.10624ep-1f, 0x1.10e56p-1f, 0x1.116872p-1f, 0x1.11eb86p-1f,
      0x1.126e98p-1f, 0x1.12f1aap-1f, 0x1.1374bcp-1f, 0x1.13f7cep-1f,
      0x1.147ae2p-1f, 0x1.14fdf4p-1f, 0x1.158106p-1f, 0x1.160418p-1f,
      0x1.16872cp-1f, 0x1.170a3ep-1f, 0x1.178d5p-1f, 0x1.181062p-1f,
      0x1.189374p-1f, 0x1.191688p-1f, 0x1.19999ap-1f, 0x1.1a1cacp-1f,
      0x1.1a9fbep-1f, 0x1.1b22dp-1f, 0x1.1ba5e4p-1f, 0x1.1c28f6p-1f,
      0x1.1cac08p-1f, 0x1.1d2f1ap-1f, 0x1.1db22ep-1f, 0x1.1e354p-1f,
      0x1.1eb852p-1f, 0x1.1f3b64p-1f, 0x1.1fbe76p-1f, 0x1.20418ap-1f,
      0x1.20c49cp-1f, 0x1.2147aep-1f, 0x1.21cacp-1f, 0x1.224dd2p-1f,
      0x1.22d0e6p-1f, 0x1.2353f8p-1f, 0x1.23d70ap-1f, 0x1.245a1cp-1f,
      0x1.24dd3p-1f, 0x1.256042p-1f, 0x1.25e354p-1f, 0x1.266666p-1f,
      0x1.26e978p-1f, 0x1.276c8cp-1f, 0x1.27ef9ep-1f, 0x1.2872bp-1f,
      0x1.28f5c2p-1f, 0x1.2978d4p-1f, 0x1.29fbe8p-1f, 0x1.2a7efap-1f,
      0x1.2b020cp-1f, 0x1.2b851ep-1f, 0x1.2c0832p-1f, 0x1.2c8b44p-1f,
      0x1.2d0e56p-1f, 0x1.2d9168p-1f,
  };
  return c[i];
}

}  // namespace restir_prof
