// The native edge trainers: complete local-SGD loops in host C++ for edge
// devices that run no tensor framework (the reference's MobileNN on-device
// trainer, android/fedmlsdk/MobileNN/src/train/FedMLMNNTrainer.cpp).
//
//  * lr_sgd_train  - softmax linear model, W [d, k] row-major then b [k];
//  * cnn_sgd_train - the 2-conv CNN of models/hub.py with a handwritten
//    backward (conv3x3 SAME + relu + maxpool2, twice; dense relu; dense).
//
// The same arithmetic, loop order and types as the JAX package's native
// tier, so the same inputs give the same bits. Built by
// fedml_tpu_torch/native/__init__.py with g++ -O3 -shared -fPIC -std=c++17
// and bound with ctypes (plain C interface); there is no fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// ------------------------------------------------- native edge trainer (LR)
// A full local-SGD loop for a softmax linear model. Layout: W [d, k] row-major then b [k].
// x [n, d] float32, y [n] int32. Minibatches are taken in the caller-
// provided order (perm [steps*bs]), so python controls shuffling/seeding.
// Returns mean loss over all steps.
double lr_sgd_train(const float* x, const int32_t* y, int64_t n, int64_t d,
                    int64_t k, float* params, const int64_t* perm,
                    int64_t steps, int64_t bs, double lr) {
    float* W = params;          // [d, k]
    float* b = params + d * k;  // [k]
    double total_loss = 0.0;
    double* logits = new double[k];
    double* gb = new double[k];
    double* gW = new double[d * k];

    for (int64_t s = 0; s < steps; ++s) {
        std::fill(gb, gb + k, 0.0);
        std::fill(gW, gW + d * k, 0.0);
        double step_loss = 0.0;
        for (int64_t bi = 0; bi < bs; ++bi) {
            int64_t idx = perm[s * bs + bi];
            const float* xi = x + idx * d;
            // logits = W^T x + b
            for (int64_t c = 0; c < k; ++c) logits[c] = b[c];
            for (int64_t j = 0; j < d; ++j) {
                double xv = xi[j];
                const float* wrow = W + j * k;
                for (int64_t c = 0; c < k; ++c) logits[c] += xv * wrow[c];
            }
            // softmax CE (stable)
            double m = logits[0];
            for (int64_t c = 1; c < k; ++c) m = std::max(m, logits[c]);
            double z = 0.0;
            for (int64_t c = 0; c < k; ++c) z += std::exp(logits[c] - m);
            int32_t yi = y[idx];
            step_loss += -(logits[yi] - m - std::log(z));
            // grad: softmax - onehot
            for (int64_t c = 0; c < k; ++c) {
                double pc = std::exp(logits[c] - m) / z - (c == yi ? 1.0 : 0.0);
                gb[c] += pc;
                for (int64_t j = 0; j < d; ++j) gW[j * k + c] += pc * xi[j];
            }
        }
        double scale = lr / (double)bs;
        for (int64_t c = 0; c < k; ++c) b[c] -= (float)(scale * gb[c]);
        for (int64_t j = 0; j < d * k; ++j) W[j] -= (float)(scale * gW[j]);
        total_loss += step_loss / (double)bs;
    }
    delete[] logits;
    delete[] gb;
    delete[] gW;
    return steps > 0 ? total_loss / (double)steps : 0.0;
}

// ------------------------------------------------ native edge trainer (CNN)
// MobileNN trains full CNNs on-device (reference: android/fedmlsdk/MobileNN/
// src/train/FedMLMNNTrainer.cpp:3-80 — mnist/cifar CNN training loops). This
// is the analog: the framework's 2-conv CNN (models/hub.py CNN — conv3x3
// SAME + relu + maxpool2, twice, then dense relu + softmax head) with a
// complete handwritten backward.
//
// Param layout: the flax CNN's leaf order (bias before kernel per module),
// conv kernels HWIO, as cross_silo/secagg_manager.py:flatten_params lays
// out the port's CNN:
//   b1[C1], k1[3][3][Cin][C1], b2[C2], k2[3][3][C1][C2],
//   bd1[Dh], w1[F][Dh], bd2[K], w2[Dh][K]      (F = H/4 * W/4 * C2)

namespace {

struct CnnDims {
    int64_t H, W, Cin, C1, C2, Dh, K;
    int64_t H2() const { return H / 2; }
    int64_t W2() const { return W / 2; }
    int64_t H4() const { return H / 4; }
    int64_t W4() const { return W / 4; }
    int64_t F() const { return H4() * W4() * C2; }
};

// conv 3x3 SAME stride 1, NHWC x HWIO -> NHWC (single sample)
static void conv3x3(const float* in, int64_t H, int64_t W, int64_t Ci,
                    const float* k, const float* b, int64_t Co, float* out) {
    for (int64_t h = 0; h < H; ++h)
        for (int64_t w = 0; w < W; ++w) {
            float* o = out + (h * W + w) * Co;
            for (int64_t c = 0; c < Co; ++c) o[c] = b[c];
            for (int64_t dh = 0; dh < 3; ++dh) {
                int64_t ih = h + dh - 1;
                if (ih < 0 || ih >= H) continue;
                for (int64_t dw = 0; dw < 3; ++dw) {
                    int64_t iw = w + dw - 1;
                    if (iw < 0 || iw >= W) continue;
                    const float* xi = in + (ih * W + iw) * Ci;
                    const float* kk = k + ((dh * 3 + dw) * Ci) * Co;
                    for (int64_t ci = 0; ci < Ci; ++ci) {
                        float xv = xi[ci];
                        const float* kr = kk + ci * Co;
                        for (int64_t c = 0; c < Co; ++c) o[c] += xv * kr[c];
                    }
                }
            }
        }
}

// transpose of conv3x3 w.r.t. input + kernel/bias grad accumulation
static void conv3x3_bwd(const float* in, int64_t H, int64_t W, int64_t Ci,
                        const float* k, int64_t Co, const float* gout,
                        float* gin, float* gk, float* gb) {
    if (gin) std::fill(gin, gin + H * W * Ci, 0.0f);
    for (int64_t h = 0; h < H; ++h)
        for (int64_t w = 0; w < W; ++w) {
            const float* go = gout + (h * W + w) * Co;
            for (int64_t c = 0; c < Co; ++c) gb[c] += go[c];
            for (int64_t dh = 0; dh < 3; ++dh) {
                int64_t ih = h + dh - 1;
                if (ih < 0 || ih >= H) continue;
                for (int64_t dw = 0; dw < 3; ++dw) {
                    int64_t iw = w + dw - 1;
                    if (iw < 0 || iw >= W) continue;
                    const float* xi = in + (ih * W + iw) * Ci;
                    float* gi = gin ? gin + (ih * W + iw) * Ci : nullptr;
                    const float* kk = k + ((dh * 3 + dw) * Ci) * Co;
                    float* gkk = gk + ((dh * 3 + dw) * Ci) * Co;
                    for (int64_t ci = 0; ci < Ci; ++ci) {
                        const float* kr = kk + ci * Co;
                        float* gkr = gkk + ci * Co;
                        float xv = xi[ci], gacc = 0.0f;
                        for (int64_t c = 0; c < Co; ++c) {
                            gkr[c] += xv * go[c];
                            gacc += kr[c] * go[c];
                        }
                        if (gi) gi[ci] += gacc;
                    }
                }
            }
        }
}

static void maxpool2(const float* in, int64_t H, int64_t W, int64_t C,
                     float* out, int32_t* arg) {
    int64_t Ho = H / 2, Wo = W / 2;
    for (int64_t h = 0; h < Ho; ++h)
        for (int64_t w = 0; w < Wo; ++w)
            for (int64_t c = 0; c < C; ++c) {
                float best = -1e30f;
                int32_t bi = 0;
                for (int64_t dh = 0; dh < 2; ++dh)
                    for (int64_t dw = 0; dw < 2; ++dw) {
                        int64_t idx = ((2 * h + dh) * W + 2 * w + dw) * C + c;
                        if (in[idx] > best) { best = in[idx]; bi = (int32_t)idx; }
                    }
                out[(h * Wo + w) * C + c] = best;
                arg[(h * Wo + w) * C + c] = bi;
            }
}

}  // namespace

// Full local-SGD loop. Returns mean loss. Scratch is allocated per call.
double cnn_sgd_train(const float* x, const int32_t* y, int64_t n,
                     int64_t H, int64_t W, int64_t Cin, int64_t C1,
                     int64_t C2, int64_t Dh, int64_t K, float* params,
                     const int64_t* perm, int64_t steps, int64_t bs,
                     double lr) {
    CnnDims d{H, W, Cin, C1, C2, Dh, K};
    // param views (flax leaf order: bias before kernel per module)
    float* b1 = params;
    float* k1 = b1 + C1;
    float* b2 = k1 + 9 * Cin * C1;
    float* k2 = b2 + C2;
    float* bd1 = k2 + 9 * C1 * C2;
    float* w1 = bd1 + Dh;
    float* bd2 = w1 + d.F() * Dh;
    float* w2 = bd2 + K;
    int64_t n_params = (w2 + Dh * K) - params;

    // activations (per sample) + batch grad accumulators
    float* a1 = new float[H * W * C1];
    float* p1 = new float[d.H2() * d.W2() * C1];
    int32_t* arg1 = new int32_t[d.H2() * d.W2() * C1];
    float* a2 = new float[d.H2() * d.W2() * C2];
    float* p2 = new float[d.H4() * d.W4() * C2];
    int32_t* arg2 = new int32_t[d.H4() * d.W4() * C2];
    float* hid = new float[Dh];
    double* logits = new double[K];
    float* g = new float[n_params];
    float* ga1 = new float[H * W * C1];
    float* ga2 = new float[d.H2() * d.W2() * C2];
    float* gp1 = new float[d.H2() * d.W2() * C1];
    float* gp2 = new float[d.H4() * d.W4() * C2];
    float* ghid = new float[Dh];

    float* gb1 = g;
    float* gk1 = gb1 + C1;
    float* gb2 = gk1 + 9 * Cin * C1;
    float* gk2 = gb2 + C2;
    float* gbd1 = gk2 + 9 * C1 * C2;
    float* gw1 = gbd1 + Dh;
    float* gbd2 = gw1 + d.F() * Dh;
    float* gw2 = gbd2 + K;

    double total_loss = 0.0;
    for (int64_t s = 0; s < steps; ++s) {
        std::fill(g, g + n_params, 0.0f);
        double step_loss = 0.0;
        for (int64_t bi = 0; bi < bs; ++bi) {
            const float* xi = x + perm[s * bs + bi] * H * W * Cin;
            int32_t yi = y[perm[s * bs + bi]];
            // ---- forward
            conv3x3(xi, H, W, Cin, k1, b1, C1, a1);
            for (int64_t i = 0; i < H * W * C1; ++i)
                if (a1[i] < 0) a1[i] = 0;
            maxpool2(a1, H, W, C1, p1, arg1);
            conv3x3(p1, d.H2(), d.W2(), C1, k2, b2, C2, a2);
            for (int64_t i = 0; i < d.H2() * d.W2() * C2; ++i)
                if (a2[i] < 0) a2[i] = 0;
            maxpool2(a2, d.H2(), d.W2(), C2, p2, arg2);
            for (int64_t j = 0; j < Dh; ++j) {
                double acc = bd1[j];
                for (int64_t f = 0; f < d.F(); ++f)
                    acc += p2[f] * w1[f * Dh + j];
                hid[j] = acc > 0 ? (float)acc : 0.0f;
            }
            for (int64_t c = 0; c < K; ++c) {
                double acc = bd2[c];
                for (int64_t j = 0; j < Dh; ++j)
                    acc += hid[j] * w2[j * K + c];
                logits[c] = acc;
            }
            double m = logits[0];
            for (int64_t c = 1; c < K; ++c) m = std::max(m, logits[c]);
            double z = 0.0;
            for (int64_t c = 0; c < K; ++c) z += std::exp(logits[c] - m);
            step_loss += -(logits[yi] - m - std::log(z));
            // ---- backward
            std::fill(ghid, ghid + Dh, 0.0f);
            for (int64_t c = 0; c < K; ++c) {
                float gl = (float)(std::exp(logits[c] - m) / z
                                   - (c == yi ? 1.0 : 0.0));
                gbd2[c] += gl;
                for (int64_t j = 0; j < Dh; ++j) {
                    gw2[j * K + c] += hid[j] * gl;
                    ghid[j] += w2[j * K + c] * gl;
                }
            }
            std::fill(gp2, gp2 + d.F(), 0.0f);
            for (int64_t j = 0; j < Dh; ++j) {
                if (hid[j] <= 0) continue;   // relu gate
                float gh = ghid[j];
                gbd1[j] += gh;
                for (int64_t f = 0; f < d.F(); ++f) {
                    gw1[f * Dh + j] += p2[f] * gh;
                    gp2[f] += w1[f * Dh + j] * gh;
                }
            }
            // unpool2 + relu gate -> ga2
            std::fill(ga2, ga2 + d.H2() * d.W2() * C2, 0.0f);
            for (int64_t i = 0; i < d.F(); ++i)
                ga2[arg2[i]] += gp2[i];
            for (int64_t i = 0; i < d.H2() * d.W2() * C2; ++i)
                if (a2[i] <= 0) ga2[i] = 0;
            conv3x3_bwd(p1, d.H2(), d.W2(), C1, k2, C2, ga2, gp1, gk2, gb2);
            // unpool1 + relu gate -> ga1
            std::fill(ga1, ga1 + H * W * C1, 0.0f);
            for (int64_t i = 0; i < d.H2() * d.W2() * C1; ++i)
                ga1[arg1[i]] += gp1[i];
            for (int64_t i = 0; i < H * W * C1; ++i)
                if (a1[i] <= 0) ga1[i] = 0;
            conv3x3_bwd(xi, H, W, Cin, k1, C1, ga1, nullptr, gk1, gb1);
        }
        float scale = (float)(lr / (double)bs);
        for (int64_t i = 0; i < n_params; ++i) params[i] -= scale * g[i];
        total_loss += step_loss / (double)bs;
    }
    delete[] a1; delete[] p1; delete[] arg1; delete[] a2; delete[] p2;
    delete[] arg2; delete[] hid; delete[] logits; delete[] g; delete[] ga1;
    delete[] ga2; delete[] gp1; delete[] gp2; delete[] ghid;
    return steps > 0 ? total_loss / (double)steps : 0.0;
}

}  // extern "C"
