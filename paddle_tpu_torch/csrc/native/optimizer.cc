// Standalone optimizer library — paddle/optimizer parity (SURVEY §2.1:
// C ABI `paddle_create_optimizer` / `paddle_update_parameter`, consumed by
// the Go pserver via cgo; sgd(momentum/nesterov), adagrad, adadelta, adam,
// const/linear lr policies, state (de)serialization).
//
// The device train step owns the hot-path updates; this library serves the
// same role as the reference's: an accelerator-free
// optimizer for host-side parameter services (runtime/master-style
// components) with checkpointable state.

#include <cmath>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "common.h"

namespace pt {
namespace {

enum OptType { SGD = 0, ADAGRAD = 1, ADADELTA = 2, ADAM = 3 };
enum LrPolicy { LR_CONST = 0, LR_LINEAR = 1 };

struct Optimizer {
  int type = SGD;
  // hyper
  double lr = 0.01, momentum = 0.0, beta1 = 0.9, beta2 = 0.999;
  double epsilon = 1e-8, rho = 0.95, decay = 0.0;
  bool nesterov = false;
  int lr_policy = LR_CONST;
  double lr_decay_a = 0.0, lr_decay_b = 0.0;  // linear: lr - a*steps, floor b
  // state
  int64_t num_updates = 0;
  std::vector<float> m0, m1;  // slot buffers (velocity / moments / accums)

  double current_lr() const {
    if (lr_policy == LR_LINEAR) {
      double v = lr - lr_decay_a * static_cast<double>(num_updates);
      return v > lr_decay_b ? v : lr_decay_b;
    }
    return lr;
  }

  bool needs_slots() const {
    return type != SGD || momentum != 0.0;
  }

  // Returns false when existing slot state is for a DIFFERENT size — a
  // resize would silently zero moments while keeping num_updates (wrong
  // Adam bias correction); callers must match sizes or reset.
  bool ensure(size_t n) {
    if (!needs_slots()) return true;
    if (!m0.empty() && m0.size() != n) return false;
    if (m0.empty()) m0.assign(n, 0.f);
    if ((type == ADADELTA || type == ADAM)) {
      if (!m1.empty() && m1.size() != n) return false;
      if (m1.empty()) m1.assign(n, 0.f);
    }
    return true;
  }

  int update(float* p, const float* g, size_t n) {
    if (!ensure(n)) return -1;
    const double cur_lr = current_lr();
    ++num_updates;
    switch (type) {
      case SGD: {
        if (momentum == 0.0) {
          for (size_t i = 0; i < n; ++i)
            p[i] -= static_cast<float>(cur_lr) * (g[i] + decay * p[i]);
        } else {
          for (size_t i = 0; i < n; ++i) {
            float gi = g[i] + static_cast<float>(decay) * p[i];
            float v = static_cast<float>(momentum) * m0[i] -
                      static_cast<float>(cur_lr) * gi;
            m0[i] = v;
            p[i] += nesterov
                        ? static_cast<float>(momentum) * v -
                              static_cast<float>(cur_lr) * gi
                        : v;
          }
        }
        break;
      }
      case ADAGRAD: {
        for (size_t i = 0; i < n; ++i) {
          m0[i] += g[i] * g[i];
          p[i] -= static_cast<float>(cur_lr) * g[i] /
                  (std::sqrt(m0[i]) + static_cast<float>(epsilon));
        }
        break;
      }
      case ADADELTA: {
        for (size_t i = 0; i < n; ++i) {
          m0[i] = static_cast<float>(rho) * m0[i] +
                  (1.f - static_cast<float>(rho)) * g[i] * g[i];
          float dx = -std::sqrt((m1[i] + static_cast<float>(epsilon)) /
                                (m0[i] + static_cast<float>(epsilon))) *
                     g[i];
          m1[i] = static_cast<float>(rho) * m1[i] +
                  (1.f - static_cast<float>(rho)) * dx * dx;
          p[i] += static_cast<float>(cur_lr) * dx;
        }
        break;
      }
      case ADAM: {
        const double b1p = std::pow(beta1, static_cast<double>(num_updates));
        const double b2p = std::pow(beta2, static_cast<double>(num_updates));
        for (size_t i = 0; i < n; ++i) {
          m0[i] = static_cast<float>(beta1) * m0[i] +
                  (1.f - static_cast<float>(beta1)) * g[i];
          m1[i] = static_cast<float>(beta2) * m1[i] +
                  (1.f - static_cast<float>(beta2)) * g[i] * g[i];
          double mhat = m0[i] / (1.0 - b1p);
          double vhat = m1[i] / (1.0 - b2p);
          p[i] -= static_cast<float>(cur_lr * mhat /
                                     (std::sqrt(vhat) + epsilon));
        }
        break;
      }
    }
    return 0;
  }
};

}  // namespace
}  // namespace pt

using pt::Optimizer;

// type: 0 sgd, 1 adagrad, 2 adadelta, 3 adam
PT_EXPORT void* pt_opt_create(int type, double lr, double momentum,
                              double beta1, double beta2, double epsilon,
                              double rho, double decay, int nesterov) {
  if (type < pt::SGD || type > pt::ADAM) return nullptr;  // unknown type
  auto* o = new (std::nothrow) Optimizer();
  if (!o) return nullptr;
  o->type = type;
  o->lr = lr;
  o->momentum = momentum;
  o->beta1 = beta1;
  o->beta2 = beta2;
  o->epsilon = epsilon;
  o->rho = rho;
  o->decay = decay;
  o->nesterov = nesterov != 0;
  return o;
}

PT_EXPORT void pt_opt_set_lr_policy(void* op, int policy, double decay_a,
                                    double decay_b) {
  auto* o = static_cast<Optimizer*>(op);
  o->lr_policy = policy;
  o->lr_decay_a = decay_a;
  o->lr_decay_b = decay_b;
}

// 0 on success; -1 when existing slot state was created for a different
// parameter size (resize would corrupt Adam bias correction).
PT_EXPORT int pt_opt_update(void* op, float* param, const float* grad,
                            uint64_t n) {
  return static_cast<Optimizer*>(op)->update(param, grad, n);
}

PT_EXPORT double pt_opt_current_lr(void* op) {
  return static_cast<Optimizer*>(op)->current_lr();
}

// Serialization: "PTOS" | version | type | num_updates | slot sizes | slots.
// Returns bytes written (call with buf=null for required size).
PT_EXPORT int64_t pt_opt_serialize(void* op, uint8_t* buf, int64_t cap) {
  auto* o = static_cast<Optimizer*>(op);
  int64_t need = 4 + 4 + 4 + 8 + 8 + 8 +
                 static_cast<int64_t>((o->m0.size() + o->m1.size()) * 4);
  if (!buf) return need;
  if (cap < need) return -1;
  uint8_t* w = buf;
  auto put = [&](const void* src, size_t k) {
    std::memcpy(w, src, k);
    w += k;
  };
  uint32_t magic = 0x50544F53u, version = 1, type = o->type;
  uint64_t n0 = o->m0.size(), n1 = o->m1.size();
  put(&magic, 4);
  put(&version, 4);
  put(&type, 4);
  put(&o->num_updates, 8);
  put(&n0, 8);
  put(&n1, 8);
  if (n0) put(o->m0.data(), n0 * 4);
  if (n1) put(o->m1.data(), n1 * 4);
  return need;
}

PT_EXPORT int pt_opt_deserialize(void* op, const uint8_t* buf, int64_t len) {
  auto* o = static_cast<Optimizer*>(op);
  if (len < 36) return -1;
  const uint8_t* r = buf;
  auto get = [&](void* dst, size_t k) {
    std::memcpy(dst, r, k);
    r += k;
  };
  uint32_t magic, version, type;
  uint64_t n0, n1;
  int64_t num_updates;
  get(&magic, 4);
  get(&version, 4);
  get(&type, 4);
  if (magic != 0x50544F53u || static_cast<int>(type) != o->type) return -1;
  get(&num_updates, 8);
  get(&n0, 8);
  get(&n1, 8);
  // overflow-safe size validation BEFORE any state mutation: each slot count
  // must individually fit in the remaining bytes
  const uint64_t avail = static_cast<uint64_t>(len) - 36;
  if (n0 > avail / 4 || n1 > avail / 4 || (n0 + n1) > avail / 4) return -1;
  std::vector<float> m0(n0), m1(n1);
  if (n0) get(m0.data(), n0 * 4);
  if (n1) get(m1.data(), n1 * 4);
  // commit only after the whole blob parsed
  o->num_updates = num_updates;
  o->m0 = std::move(m0);
  o->m1 = std::move(m1);
  return 0;
}

PT_EXPORT void pt_opt_destroy(void* op) { delete static_cast<Optimizer*>(op); }
