// Native C++/OpenMP oracle for the nbody_jax N-body engine.
//
// Role: an independent, non-JAX implementation of the softened pairwise
// force law and the Hilbert key, used by the test harness as a
// cross-language ground truth (the reference suite's native compute path —
// methods.cpp:7-136 — re-expressed for the oracle role; the engine's
// hot path lives in Pallas/XLA, not here).
//
// Exposed C ABI (see nbody_jax/utils/native.py for the ctypes binding):
//   nbody_brute_force(positions, masses, n, dim, G, softening, out_forces)
//   nbody_hilbert_keys(coords_u32, n, dim, bits, out_keys)
//
// Build: make -C native   (produces libnbody_oracle.so)

#include <cmath>
#include <cstdint>

extern "C" {

// Softened attractive gravity, double precision, OpenMP row-parallel.
// Matches ops/brute_force.py semantics: Plummer softening plus the
// reference's dist^2 < 1e-10 pair-skip guard (methods.cpp:24).
void nbody_brute_force(const double* positions, const double* masses,
                       long n, int dim, double G, double softening,
                       double* out_forces) {
    const double soft2 = softening * softening;
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        double acc[3] = {0.0, 0.0, 0.0};
        const double* pi = positions + i * dim;
        for (long j = 0; j < n; ++j) {
            if (j == i) continue;
            const double* pj = positions + j * dim;
            double diff[3] = {0.0, 0.0, 0.0};
            double d2 = 0.0;
            for (int d = 0; d < dim; ++d) {
                diff[d] = pj[d] - pi[d];
                d2 += diff[d] * diff[d];
            }
            if (d2 < 1e-10) continue;
            const double inv_r = 1.0 / std::sqrt(d2 + soft2);
            const double w = masses[j] * inv_r * inv_r * inv_r;
            for (int d = 0; d < dim; ++d) acc[d] += w * diff[d];
        }
        for (int d = 0; d < dim; ++d)
            out_forces[i * dim + d] = G * masses[i] * acc[d];
    }
}

// Exact Hilbert index from pre-quantized grid coords (Skilling transform,
// scalar form — the reference's hilbert_key at vector.h:151-192 is a dead
// XOR-fold approximation; this matches ops/keys.py's vectorized version).
void nbody_hilbert_keys(const uint32_t* coords, long n, int dim, int bits,
                        uint32_t* out_keys) {
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; ++i) {
        uint32_t x[3];
        for (int d = 0; d < dim; ++d) x[d] = coords[i * dim + d];

        // Inverse undo excess work.
        for (uint32_t q = 1u << (bits - 1); q > 1; q >>= 1) {
            const uint32_t p = q - 1;
            for (int d = 0; d < dim; ++d) {
                if (x[d] & q) {
                    x[0] ^= p;  // invert
                } else {
                    const uint32_t t = (x[0] ^ x[d]) & p;
                    x[0] ^= t;
                    x[d] ^= t;
                }
            }
        }
        // Gray encode.
        for (int d = 1; d < dim; ++d) x[d] ^= x[d - 1];
        uint32_t t = 0;
        for (uint32_t q = 1u << (bits - 1); q > 1; q >>= 1)
            if (x[dim - 1] & q) t ^= q - 1;
        for (int d = 0; d < dim; ++d) x[d] ^= t;

        // Interleave transposed bits, x[0] major.
        uint32_t key = 0;
        for (int b = bits - 1; b >= 0; --b)
            for (int d = 0; d < dim; ++d)
                key = (key << 1) | ((x[d] >> b) & 1u);
        out_keys[i] = key;
    }
}

}  // extern "C"
