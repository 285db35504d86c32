// FlexiFault's post-commit fault transform for one lane, shared by the CUDA
// segment kernel (iss_segment.cu, through rv32e_step.cuh's run_lane) and a
// host build that the CPU tests compile with g++ (plain C++ when
// __CUDACC__ is undefined).
//
// It is the per-lane form of the reference's
// src/repro/flexibits/faults.py::apply_fault_arrays, which the TPU kernel
// src/repro/kernels/iss_stepper.py::_step_tile applies after every commit
// (iss_stepper.py:152-160), gated on the lane having stepped and not halted
// on that step. Every draw is a murmur3 finalizer (mix32) of the lane's key,
// its retry epoch and its post-commit n_instr:
//  - transient: h0 = mix32(mix32(key ^ mix32(epoch)) ^ n_instr) fires when
//    h0 < threshold (or always); then h1 = mix32(h0 ^ T1) picks the target
//    (h1 % n_targets, over the spec's canonical order regs, mem, pc) and the
//    register (1 + (h1 >> 8) % 15) or memory word ((h1 >> 8) % mem_len, the
//    lane's own word count), and h2 = mix32(h1 ^ T2) the bit (h2 % 32; the
//    pc flips bit 2 + h2 % 10, so it stays word-aligned);
//  - stuck: a lane whose mix32(key ^ STUCK) is under the threshold forces
//    one drawn register bit to a drawn value after every step;
//  - dead: a lane whose mix32(key ^ DEAD) is under the threshold reads an
//    all-zero register file after every step.
// The per-lane parts of these (the transient key k, stuck's register, mask
// and value, the defect decisions) do not depend on the step: lane_consts
// computes them once per lane and segment.
//
// All arithmetic is on uint32_t (signed overflow is undefined in C++), and
// every modulus is unsigned, as the reference's uint32 jnp arithmetic is.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FF_HD __host__ __device__ __forceinline__
#else
#define FF_HD inline
#endif

namespace flexifault {

enum : int { NONE = 0, TRANSIENT = 1, STUCK = 2, DEAD = 3 };
enum : int32_t { REGS = 0, MEM = 1, PC = 2 };

// derivation salts of faults.py (_T1, _T2, _STUCK, _DEAD)
constexpr uint32_t kT1 = 0x9E3779B9u;
constexpr uint32_t kT2 = 0x632BE59Bu;
constexpr uint32_t kStuck = 0x27220A95u;
constexpr uint32_t kDead = 0x85157AF5u;

FF_HD uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The schedule, the same for every lane: draw < threshold fires (always:
// unconditionally); target[t] is the t-th enabled transient target.
struct Spec {
  uint32_t threshold;
  int32_t always;
  int32_t n_targets;
  int32_t target[3];
};

// One lane's step-independent constants.
struct LaneConsts {
  uint32_t k;     // transient: mix32(key ^ mix32(epoch))
  bool hit;       // stuck, dead: the lane's defect is active
  int32_t reg;    // stuck: the register, its bit and the forced value
  uint32_t mask;
  bool one;
};

template <int MODE>
FF_HD LaneConsts lane_consts(const Spec& sp, uint32_t key, int32_t epoch) {
  LaneConsts c{};
  if constexpr (MODE == TRANSIENT) {
    c.k = mix32(key ^ mix32(static_cast<uint32_t>(epoch)));
  } else if constexpr (MODE == STUCK) {
    const uint32_t sk = mix32(key ^ kStuck);
    c.hit = sp.always != 0 || sk < sp.threshold;
    const uint32_t s1 = mix32(sk ^ kT1);
    c.reg = static_cast<int32_t>(1u + (s1 >> 8) % 15u);
    c.mask = 1u << (s1 % 32u);
    c.one = ((s1 >> 5) & 1u) != 0;
  } else if constexpr (MODE == DEAD) {
    c.hit = sp.always != 0 || mix32(key ^ kDead) < sp.threshold;
  }
  return c;
}

// The transform after a commit that left the lane live and not halted.
// Registers are reached through a stride (the kernel keeps them in shared
// memory laid out [index][lane]); `mem` is the lane's row, of which the
// first `mlen` words are its program's; `n_instr` is the post-commit count.
// A memory flip is one read-modify-write of the drawn word.
template <int MODE>
FF_HD void apply(const Spec& sp, const LaneConsts& c, int32_t* regs,
                 int regs_stride, int32_t* mem, int32_t mlen, int32_t& pc,
                 int32_t n_instr) {
  if constexpr (MODE == DEAD) {
    if (c.hit)
      for (int r = 0; r < 16; ++r) regs[r * regs_stride] = 0;
  } else if constexpr (MODE == STUCK) {
    if (c.hit) {
      int32_t& w = regs[c.reg * regs_stride];
      const uint32_t u = static_cast<uint32_t>(w);
      w = static_cast<int32_t>(c.one ? (u | c.mask) : (u & ~c.mask));
    }
  } else if constexpr (MODE == TRANSIENT) {
    const uint32_t h0 = mix32(c.k ^ static_cast<uint32_t>(n_instr));
    if (sp.always == 0 && h0 >= sp.threshold) return;
    const uint32_t h1 = mix32(h0 ^ kT1);
    const uint32_t h2 = mix32(h1 ^ kT2);
    const uint32_t bmask = 1u << (h2 % 32u);
    switch (sp.target[h1 % static_cast<uint32_t>(sp.n_targets)]) {
      case REGS: {
        int32_t& w = regs[(1u + (h1 >> 8) % 15u) * regs_stride];
        w = static_cast<int32_t>(static_cast<uint32_t>(w) ^ bmask);
        break;
      }
      case MEM: {
        int32_t& w = mem[(h1 >> 8) % static_cast<uint32_t>(mlen)];
        w = static_cast<int32_t>(static_cast<uint32_t>(w) ^ bmask);
        break;
      }
      default:
        pc = static_cast<int32_t>(static_cast<uint32_t>(pc) ^
                                  (1u << (2u + h2 % 10u)));
        break;
    }
  }
}

}  // namespace flexifault
