// Native planning layer: radix factorization + high-precision twiddles.
//
// C++ counterpart of the reference's shared planner
// (/root/reference/simd/chowdsp_fft_impl_common.hpp:51-228): decompose() and
// the rffti1/cffti1 twiddle fills. Two deliberate upgrades over both the
// reference and the numpy fallback:
//   * twiddles are evaluated in long double with argument reduction
//     (k mod n before scaling), so even N = 2^20 tables are correctly
//     rounded to float64 — the reference computes them in float32
//     (common.hpp:111-113), which SURVEY.md flags as its accuracy ceiling;
//   * plan construction is allocation-free for the caller: sizes are
//     queried first, buffers are caller-owned (the moral equivalent of
//     fft_new_setup_preallocated, /root/reference/chowdsp_fft.h:98-118).
//
// Exposed with C linkage for ctypes (no pybind11 on this image).

#include <cmath>
#include <cstdint>

namespace {

constexpr long double kTwoPi = 6.283185307179586476925286766559L;

// Greedy factorization over {4, 2, 3, 5}; mirrors common::decompose
// semantics. Returns the number of radices, or -1 if n has other factors.
int factorize(int n, int* out, int cap) {
    int cnt = 0;
    int m = n;
    auto push = [&](int r) {
        if (out != nullptr && cnt < cap) out[cnt] = r;
        ++cnt;
    };
    while (m % 4 == 0) { push(4); m /= 4; }
    if (m % 2 == 0) { push(2); m /= 2; }
    while (m % 3 == 0) { push(3); m /= 3; }
    while (m % 5 == 0) { push(5); m /= 5; }
    if (m != 1) return -1;
    return cnt;
}

// exp(-2*pi*i * num / den) with exact argument reduction.
inline void cis(std::int64_t num, std::int64_t den, double* re, double* im) {
    const std::int64_t r = num % den;
    const long double ang = -kTwoPi * static_cast<long double>(r) /
                            static_cast<long double>(den);
    *re = static_cast<double>(cosl(ang));
    *im = static_cast<double>(sinl(ang));
}

}  // namespace

extern "C" {

// Returns the number of radices for n, or -1 if unsupported.
int chow_factorize(int n, int* radices_out, int cap) {
    if (n < 2) return -1;
    return factorize(n, radices_out, cap);
}

// Total float64 element count of all per-stage twiddle tables for a
// complex transform of length n (each stage contributes r*m = current
// sub-length complex values -> 2*sub doubles). Returns -1 if unsupported.
std::int64_t chow_stage_table_size(int n) {
    int radices[64];
    const int cnt = factorize(n, radices, 64);
    if (cnt < 0) return -1;
    std::int64_t total = 0;
    int sub = n;
    for (int t = 0; t < cnt; ++t) {
        total += 2LL * sub;  // re+im for r*m == sub entries
        sub /= radices[t];
    }
    return total;
}

// Fill per-stage twiddle tables for the mixed-radix Stockham plan.
// Layout: for each stage t (radix r, m = sub/r), row-major (r, m) complex
// values W_sub^(j*p) stored as separate re then im planes of length r*m:
//   [stage0 re (sub0) | stage0 im (sub0) | stage1 re | stage1 im | ...]
// Returns the number of stages or -1.
int chow_fill_stage_twiddles(int n, double* out) {
    int radices[64];
    const int cnt = factorize(n, radices, 64);
    if (cnt < 0) return -1;
    int sub = n;
    double* p = out;
    for (int t = 0; t < cnt; ++t) {
        const int r = radices[t];
        const int m = sub / r;
        double* re = p;
        double* im = p + static_cast<std::int64_t>(r) * m;
        for (int j = 0; j < r; ++j) {
            for (int q = 0; q < m; ++q) {
                cis(static_cast<std::int64_t>(j) * q, sub, re, im);
                ++re;
                ++im;
            }
        }
        p += 2LL * r * m;
        sub = m;
    }
    return cnt;
}

// Half-complex split twiddles exp(-2*pi*i*k/n), k in [0, n/2):
// out = [re(n/2) | im(n/2)].
int chow_fill_rfft_twiddles(int n, double* out) {
    if (n < 2 || n % 2 != 0) return -1;
    const int m = n / 2;
    double* re = out;
    double* im = out + m;
    for (int k = 0; k < m; ++k) {
        cis(k, n, re + k, im + k);
    }
    return m;
}

}  // extern "C"
