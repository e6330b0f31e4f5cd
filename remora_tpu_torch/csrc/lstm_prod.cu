// The f32 products of lstm_prod.cuh behind a C entry of their own, each op
// alone on the path its caller names (kernels/lstm.py::lstm_prod_f32): the
// gate recompute Z, Z_x (the W_h-ring forward's x_t . W_x + b), dx and dW
// with its ordered chunk sum. K3 and the W_h-ring K1/K2 launch the same
// products from their own libraries, on the path launch_f32_op picks by
// shape; this entry lets the card tests and the timing scripts hold the
// Hopper kernel (prod_f32_ws_kernel) to the element kernel
// (wide_prod_f32_kernel) and to the plain twins on the same operands.

#include "lstm_prod.cuh"

extern "C" {

// op: 0 the gates Z (T, B, 4H), 1 dx (T, B, C), 2 dW (C + H + 1, 4H) (its
// chunks' partials, lstm_prod_dw_chunks of them, then their ordered sum),
// 3 Z_x (T, B, 4H); path: 0 by shape, 1 the Hopper kernel, 2 the element
// kernel. Operands an op does not read may be null (w_xt is W_aug[:C]^T,
// (4H, C), dx's only). Returns the cudaError_t of its launches (0 =
// launched): cudaErrorInvalidValue for an unknown op or path, or the
// Hopper path where C, H or an operand's alignment refuse it.
int lstm_prod_f32(int op, int path, const void* x, const void* hs,
                  const void* w_aug, const void* w_xt, const void* dg,
                  void* out, void* partials, int n_steps, int B, int C, int H,
                  void* stream) {
  if (op < 0 || op > 3 || path < 0 || path > 2 || n_steps < 0 || B < 1 ||
      C < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  prod::Prod<float> p = {};
  p.x = static_cast<const float*>(x);
  p.hs = static_cast<const float*>(hs);
  p.w = static_cast<const float*>(w_aug);
  p.wxt = static_cast<const float*>(w_xt);
  p.dg = static_cast<const float*>(dg);
  p.z = static_cast<float*>(out);
  p.dx = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.TB = (long long)n_steps * B;
  p.B = B;
  p.C = C;
  p.H = H;
  // the K3 libraries' rule (Z_x reads no h: H free)
  p.vec = C % 4 == 0 && (op == prod::kGatesX || H % 4 == 0) &&
          prod::aligned16(x) && prod::aligned16(hs) &&
          prod::aligned16(w_aug) && prod::aligned16(w_xt) &&
          prod::aligned16(dg);
  const int chunks = prod::dw_chunks(p.TB);
  cudaError_t err;
  switch (op) {
    case prod::kGates:
      err = prod::launch_f32_op<prod::kGates>(p, chunks, s, path);
      break;
    case prod::kDx:
      err = prod::launch_f32_op<prod::kDx>(p, chunks, s, path);
      break;
    case prod::kDw:
      err = prod::launch_f32_op<prod::kDw>(p, chunks, s, path);
      if (err == cudaSuccess) {  // no chunk: zeros
        launch_ordered_sum<0>(p.partials, static_cast<float*>(out), chunks,
                              (C + H + 1) * 4 * H, s);
      }
      break;
    default:
      err = prod::launch_f32_op<prod::kGatesX>(p, chunks, s, path);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int lstm_prod_dw_chunks(int n_steps, int B) {
  return prod::dw_chunks((long long)n_steps * B);
}

const char* lstm_prod_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
