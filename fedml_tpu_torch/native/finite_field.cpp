// Finite-field host functions of the SecAgg path (mpc/finite.py): the batch
// Fermat inverse and the Lagrange basis at zero that Shamir reconstruction
// multiplies the shares by. The same 128-bit mulmod / square-and-multiply
// powmod as the JAX package's native tier, so every value is the same in
// both packages.
//
// Built by fedml_tpu_torch/native/__init__.py with g++ -O3 -shared -fPIC
// and bound with ctypes (plain C interface).

#include <cstdint>

extern "C" {

// (a * b) mod p without overflow: operands < 2^62, product in 128 bits.
static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t p) {
    return (uint64_t)(((unsigned __int128)a * b) % p);
}

static inline uint64_t powmod(uint64_t base, uint64_t exp, uint64_t p) {
    uint64_t r = 1 % p;
    base %= p;
    while (exp) {
        if (exp & 1) r = mulmod(r, base, p);
        base = mulmod(base, base, p);
        exp >>= 1;
    }
    return r;
}

// out[i] = x[i]^(p-2) mod p (Fermat inverse; p prime).
void ff_modinv_batch(const int64_t* x, int64_t* out, int64_t n, int64_t p) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t v = x[i] % p;
        if (v < 0) v += p;
        out[i] = (int64_t)powmod((uint64_t)v, (uint64_t)(p - 2), (uint64_t)p);
    }
}

// Lagrange basis at zero for points[k]:
// lam[i] = prod_{j != i} (-x_j) / (x_i - x_j) mod p, the Shamir
// reconstruction coefficients.
void ff_lagrange_at_zero(const int64_t* points, int64_t* lam, int64_t k,
                         int64_t p) {
    for (int64_t i = 0; i < k; ++i) {
        uint64_t num = 1, den = 1;
        for (int64_t j = 0; j < k; ++j) {
            if (i == j) continue;
            int64_t nj = (-points[j]) % p; if (nj < 0) nj += p;
            int64_t dj = (points[i] - points[j]) % p; if (dj < 0) dj += p;
            num = mulmod(num, (uint64_t)nj, (uint64_t)p);
            den = mulmod(den, (uint64_t)dj, (uint64_t)p);
        }
        uint64_t inv = powmod(den, (uint64_t)(p - 2), (uint64_t)p);
        lam[i] = (int64_t)mulmod(num, inv, (uint64_t)p);
    }
}

}  // extern "C"
