// Exact nearest-rank quantiles per window on Hopper.
//
// Replaces m3_tpu/ops/downsample.py: window_quantiles (K4), which sorts each
// window of k values (invalid and NaN entries keyed +inf) and picks rank
// clip(ceil(q*n), 1, max(n, 1)) - 1 with a one-hot masked sum.
//
// One thread per (lane, window), all Q quantiles in the same thread.  No
// scratch sort: the element at 0-indexed rank r of a stable sort is the one
// whose stable rank #{j: v_j < v_i} + #{j < i: v_j == v_i} equals r
// (-0.0 == +0.0, as in jnp.sort).  That is O(k^2) compares per window,
// for any k, with the window's values read from L1.
//
// What bounds it on an H100: the bytes (each f64 value and its mask byte
// read once, Q f64 written per window) for small k; the k^2 compares past
// k of a few dozen.
//
// The reference's masked sum adds +0.0 terms to the picked value, so a
// picked -0.0 comes out +0.0 when k > 1 and stays -0.0 when k == 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxQ = 32;

struct Quantiles {
  double q[kMaxQ];
};

__global__ void __launch_bounds__(kThreads) window_quantiles_kernel(
    const double* __restrict__ values, const bool* __restrict__ mask, long long n_windows, int k,
    Quantiles qs, int n_q, double* __restrict__ out) {
  const long long wi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= n_windows) return;
  // windows tile each row exactly (T % k == 0), so window wi starts at wi * k
  const double* v = values + wi * k;
  const bool* m = mask + wi * k;
  int n = 0;
  for (int i = 0; i < k; ++i) n += (m[i] && !isnan(v[i]));
  int rank[kMaxQ];
  double picked[kMaxQ];
  for (int qi = 0; qi < n_q; ++qi) {
    int r = (int)ceil(qs.q[qi] * (double)n);
    const int hi = n > 1 ? n : 1;
    r = r < 1 ? 1 : (r > hi ? hi : r);
    rank[qi] = r - 1;
    picked[qi] = 0.0;
  }
  for (int i = 0; i < k; ++i) {
    const double key_i = (m[i] && !isnan(v[i])) ? v[i] : INFINITY;
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const double key_j = (m[j] && !isnan(v[j])) ? v[j] : INFINITY;
      r += (key_j < key_i) || (j < i && key_j == key_i);
    }
    for (int qi = 0; qi < n_q; ++qi)
      if (r == rank[qi]) picked[qi] = key_i;
  }
  double* o = out + wi * n_q;
  for (int qi = 0; qi < n_q; ++qi) {
    double p = picked[qi];
    if (k > 1 && p == 0.0) p = 0.0;  // the masked sum's -0.0 + 0.0
    o[qi] = n > 0 ? p : 0.0;
  }
}

}  // namespace

extern "C" {

// values f64[L*T], mask bool[L*T] (row-major, T % k == 0) -> out f64[L*T/k, n_q].
// Launches on `stream` and returns cudaGetLastError().
int m3_window_quantiles(const double* values, const bool* mask, long long n_windows, int k,
                        const double* quantiles_host, int n_q, double* out, void* stream) {
  if (n_q < 0 || n_q > kMaxQ) return (int)cudaErrorInvalidValue;
  Quantiles qs;
  for (int i = 0; i < n_q; ++i) qs.q[i] = quantiles_host[i];
  const long long blocks = (n_windows + kThreads - 1) / kThreads;
  window_quantiles_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      values, mask, n_windows, k, qs, n_q, out);
  return (int)cudaGetLastError();
}

const char* m3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
