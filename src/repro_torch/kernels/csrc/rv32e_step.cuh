// One RV32E lane: decode, execute and commit, shared by the CUDA segment
// kernel (iss_segment.cu) and a host build that the CPU tests compile with
// g++ (the header is plain C++ when __CUDACC__ is undefined).
//
// It is the per-lane form of the reference's branchless commit pipeline
// (src/repro/flexibits/iss.py::branchless_commits, as run by the TPU
// kernel src/repro/kernels/iss_stepper.py::iss_segment_banked), decoding
// the full RV32E set. The reference's kernel is built per opcode subset;
// this one ignores the subset, which is sound: the text subset holds
// every opcode a lane can fetch (the fetch clamps into the program), and a
// reachable-only subset drops only words that no live lane retires.
//
// Where a bit-exact port breaks, and what this file does about it:
//  1. Unsigned arithmetic. Every add, subtract and multiply runs on
//     uint32_t (signed overflow is undefined behaviour in C++); results
//     are reinterpreted as int32 two's complement, as the reference's
//     int32 arrays wrap. The fetch word index is (uint32)pc >> 2, so a
//     negative pc is a huge address and clamps high. The data word index
//     is the int32 address shifted arithmetically (iss.py:477): a negative
//     address reads word 0 and its store drops.
//  2. Shifts. sll and srl are logical on uint32 with sh = y & 31, sra is
//     arithmetic (asr below spells it out; >> on a negative int is only
//     implementation-defined before C++20).
//  3. Selects. jnp.select picks the first true case: a branch with f3 in
//     {2, 3} is never taken, loads clip f3 to [0, 5] and stores to [0, 2],
//     and the dynamic timing terms clip the same way.
//  4. Unknown opcodes. A word whose opcode is outside RV32E retires as a
//     no-op that writes 0 to rd != 0 and advances pc by 4, exactly as
//     branchless_commits does (wr defaults to 0).
//  5. Counters. The caller steps a lane only while it is live (not halted,
//     under its budget), so every counter here is the live-masked one;
//     n_cycles is int32 and wraps.
//  6. Faults. run_lane's FAULT mode (flexifault.cuh) applies the
//     post-commit fault transform after every step that leaves the lane
//     not halted, with n_instr already counting the step, as the
//     reference's _step_tile does; FAULT = NONE compiles it out.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "flexifault.cuh"

#ifdef __CUDACC__
#define RV_HD __host__ __device__ __forceinline__
#else
#define RV_HD inline
#endif

namespace rv32e {

enum : int32_t {
  OP_LUI = 0x37, OP_AUIPC = 0x17, OP_JAL = 0x6F, OP_JALR = 0x67,
  OP_BRANCH = 0x63, OP_LOAD = 0x03, OP_STORE = 0x23, OP_IMM = 0x13,
  OP_REG = 0x33, OP_SYSTEM = 0x73,
};

// mix classes in cycles.MIX_CLASSES order, and the cost-row layout of
// cycles.cost_row: [0:8) one-stage base, [8:16) two-stage base, then the
// taken-branch, per-shift-bit and subword terms
enum : int32_t {
  MIX_LOADS = 0, MIX_STORES = 1, MIX_BRANCHES = 2, MIX_JUMPS = 3,
  MIX_SHIFTS = 4, MIX_ITYPE = 5, MIX_RTYPE = 6, MIX_SYSTEM = 7,
  N_MIX = 8, N_COST = 19, TAKEN_IDX = 16, SHIFT_IDX = 17, SUBWORD_IDX = 18,
};

// read-only load: through the read-only data path on the device
RV_HD int32_t ldg(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

RV_HD int32_t u2i(uint32_t v) { return static_cast<int32_t>(v); }
RV_HD uint32_t i2u(int32_t v) { return static_cast<uint32_t>(v); }
RV_HD int32_t wadd(int32_t a, int32_t b) { return u2i(i2u(a) + i2u(b)); }
RV_HD int32_t wsub(int32_t a, int32_t b) { return u2i(i2u(a) - i2u(b)); }

// arithmetic shift right, well defined for negative values
RV_HD int32_t asr(int32_t x, uint32_t s) {
  return x < 0 ? u2i(~(~i2u(x) >> s)) : u2i(i2u(x) >> s);
}

// sign-extend the low `bits` bits of v (v < 2^bits)
RV_HD int32_t sx(uint32_t v, int bits) {
  const uint32_t m = 1u << (bits - 1);
  return u2i((v ^ m) - m);
}

RV_HD int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

RV_HD int32_t alu(int32_t a, int32_t y, int32_t f3, bool is_sub,
                  bool is_sra) {
  const uint32_t sh = i2u(y) & 31u;
  switch (f3) {
    case 0: return is_sub ? wsub(a, y) : wadd(a, y);
    case 1: return u2i(i2u(a) << sh);
    case 2: return a < y ? 1 : 0;
    case 3: return i2u(a) < i2u(y) ? 1 : 0;
    case 4: return a ^ y;
    case 5: return is_sra ? asr(a, sh) : u2i(i2u(a) >> sh);
    case 6: return a | y;
    default: return a & y;
  }
}

RV_HD bool branch_taken(int32_t a, int32_t b, int32_t f3) {
  switch (f3) {
    case 0: return a == b;
    case 1: return a != b;
    case 4: return a < b;
    case 5: return a >= b;
    case 6: return i2u(a) < i2u(b);
    case 7: return i2u(a) >= i2u(b);
    default: return false;  // f3 2 and 3: never taken
  }
}

RV_HD int32_t load_value(int32_t word, int32_t addr, int32_t f3) {
  const uint32_t sh8 = i2u(addr & 3) * 8u;
  const uint32_t sh16 = i2u(addr & 2) * 8u;
  const uint32_t byte = (i2u(word) >> sh8) & 0xFFu;
  const uint32_t half = (i2u(word) >> sh16) & 0xFFFFu;
  switch (clampi(f3, 0, 5)) {
    case 0: return sx(byte, 8);
    case 1: return sx(half, 16);
    case 4: return u2i(byte);
    case 5: return u2i(half);
    default: return word;  // lw, and the unused f3 = 3
  }
}

RV_HD int32_t store_word(int32_t word, int32_t addr, int32_t b, int32_t f3) {
  const uint32_t sh8 = i2u(addr & 3) * 8u;
  const uint32_t sh16 = i2u(addr & 2) * 8u;
  const uint32_t w = i2u(word), bu = i2u(b);
  switch (clampi(f3, 0, 2)) {
    case 0: {
      const uint32_t m = 0xFFu << sh8;
      return u2i((w & ~m) | (((bu & 0xFFu) << sh8) & m));
    }
    case 1: {
      const uint32_t m = 0xFFFFu << sh16;
      return u2i((w & ~m) | (((bu & 0xFFFFu) << sh16) & m));
    }
    default: return b;
  }
}

// One lane's architectural state, as the segment loop holds it. Registers
// and mix counters are reached through a stride, so the CUDA kernel can
// keep them in shared memory laid out [index][lane] (one bank per lane)
// while the host build uses plain arrays (stride 1).
struct Lane {
  int32_t* regs;
  int regs_stride;
  int32_t* mix;
  int mix_stride;
  int32_t pc;
  bool halted;
  int32_t n_instr;
  int32_t n_two;
  int32_t n_cycles;

  RV_HD int32_t reg(int32_t r) const { return regs[r * regs_stride]; }
  RV_HD void set_reg(int32_t r, int32_t v) { regs[r * regs_stride] = v; }
  RV_HD void bump_mix(int32_t c) { mix[c * mix_stride] += 1; }
};

// The lane's program and memory: `code` is its bank row (clen words,
// read-only), `mem` its own row of the pool (mlen of the pool's words are
// its program's; a read clamps into [0, mlen - 1], a store outside
// [0, mlen) drops), `cost` its program's cost row (TIMING only).
struct Program {
  const int32_t* code;
  int32_t clen;
  int32_t* mem;
  int32_t mlen;
  const int32_t* cost;
};

// Retire one instruction on a live lane.
template <bool TIMING>
RV_HD void step(Lane& s, const Program& p) {
  // ---- fetch: per-program pc clamp, (uint32)pc >> 2
  const int32_t pword = clampi(u2i(i2u(s.pc) >> 2), 0, p.clen - 1);
  const int32_t ii = ldg(p.code + pword);
  const uint32_t iu = i2u(ii);

  // ---- decode (fields are extracted from the unsigned pattern)
  const int32_t op = u2i(iu & 0x7Fu);
  const int32_t rd = u2i((iu >> 7) & 0xFu);
  const int32_t f3 = u2i((iu >> 12) & 0x7u);
  const int32_t rs1 = u2i((iu >> 15) & 0xFu);
  const int32_t rs2 = u2i((iu >> 20) & 0xFu);
  const bool sub_bit = ((iu >> 30) & 1u) != 0;
  const int32_t imm_i = sx(iu >> 20, 12);
  const int32_t imm_s = sx(((iu >> 25) << 5) | ((iu >> 7) & 0x1Fu), 12);
  const int32_t imm_b = sx(((iu >> 31) & 1u) << 12 | ((iu >> 7) & 1u) << 11 |
                               ((iu >> 25) & 0x3Fu) << 5 |
                               ((iu >> 8) & 0xFu) << 1,
                           13);
  const int32_t imm_u = u2i(iu & 0xFFFFF000u);
  const int32_t imm_j = sx(((iu >> 31) & 1u) << 20 | ((iu >> 12) & 0xFFu) << 12 |
                               ((iu >> 20) & 1u) << 11 |
                               ((iu >> 21) & 0x3FFu) << 1,
                           21);

  const int32_t a = s.reg(rs1);
  const int32_t b = s.reg(rs2);
  const int32_t pc = s.pc;
  const int32_t pc4 = wadd(pc, 4);

  int32_t wr = 0;  // rd value; 0 for classes that write nothing
  int32_t next_pc = pc4;
  bool taken = false;

  switch (op) {
    case OP_LUI: wr = imm_u; break;
    case OP_AUIPC: wr = wadd(pc, imm_u); break;
    case OP_JAL: wr = pc4; next_pc = wadd(pc, imm_j); break;
    case OP_JALR: wr = pc4; next_pc = wadd(a, imm_i) & ~1; break;
    case OP_BRANCH:
      taken = branch_taken(a, b, f3);
      if (taken) next_pc = wadd(pc, imm_b);
      break;
    case OP_LOAD:
    case OP_STORE: {
      // one word port serves both; the word index is the int32 address
      // shifted arithmetically
      const bool is_store = op == OP_STORE;
      const int32_t addr = wadd(a, is_store ? imm_s : imm_i);
      const int32_t widx = asr(addr, 2);
      const int32_t word = p.mem[clampi(widx, 0, p.mlen - 1)];
      if (is_store) {
        if (widx >= 0 && widx < p.mlen) p.mem[widx] = store_word(word, addr, b, f3);
      } else {
        wr = load_value(word, addr, f3);
      }
      break;
    }
    case OP_IMM:
    case OP_REG: {
      const bool is_reg = op == OP_REG;
      wr = alu(a, is_reg ? b : imm_i, f3, is_reg && sub_bit,
               f3 == 5 && sub_bit);
      break;
    }
    default: break;  // SYSTEM halts; an unknown opcode is a no-op
  }

  // ---- classify: two-stage timing class and Fig. 2a mix category
  const bool shift = (op == OP_IMM || op == OP_REG) && (f3 == 1 || f3 == 5);
  const bool slt = (op == OP_IMM || op == OP_REG) && (f3 == 2 || f3 == 3);
  const bool two_stage = op == OP_LOAD || op == OP_STORE || op == OP_BRANCH ||
                         op == OP_JAL || op == OP_JALR || shift || slt;
  int32_t mix_idx;
  if (op == OP_LOAD) mix_idx = MIX_LOADS;
  else if (op == OP_STORE) mix_idx = MIX_STORES;
  else if (op == OP_BRANCH) mix_idx = MIX_BRANCHES;
  else if (op == OP_JAL || op == OP_JALR) mix_idx = MIX_JUMPS;
  else if (shift) mix_idx = MIX_SHIFTS;
  else if (op == OP_IMM || op == OP_LUI || op == OP_AUIPC) mix_idx = MIX_ITYPE;
  else if (op == OP_REG) mix_idx = MIX_RTYPE;
  else mix_idx = MIX_SYSTEM;

  if (TIMING) {
    const uint32_t shamt =
        shift ? (i2u(op == OP_REG ? b : imm_i) & 31u) : 0u;
    const int32_t lf3 = clampi(f3, 0, 5), sf3 = clampi(f3, 0, 2);
    const bool subword = (op == OP_LOAD && lf3 != 2 && lf3 != 3) ||
                         (op == OP_STORE && sf3 != 2);
    uint32_t ticks = i2u(ldg(p.cost + (two_stage ? N_MIX : 0) + mix_idx));
    if (taken) ticks += i2u(ldg(p.cost + TAKEN_IDX));
    ticks += shamt * i2u(ldg(p.cost + SHIFT_IDX));
    if (subword) ticks += i2u(ldg(p.cost + SUBWORD_IDX));
    s.n_cycles = u2i(i2u(s.n_cycles) + ticks);
  }

  // ---- commit
  if (rd != 0 && op != OP_BRANCH && op != OP_STORE && op != OP_SYSTEM)
    s.set_reg(rd, wr);
  s.pc = next_pc;
  s.halted = s.halted || op == OP_SYSTEM;
  s.n_instr += 1;
  s.n_two += two_stage ? 1 : 0;
  s.bump_mix(mix_idx);
}

// Up to seg_steps steps while the lane is live (not halted, under its own
// budget). A lane that stops being live stays so within a segment, so
// breaking out per lane is exact with the reference's pool-wide loop.
// With a FAULT mode, `fs` is the schedule and `fc` the lane's constants.
template <bool TIMING, int FAULT = flexifault::NONE>
RV_HD void run_lane(Lane& s, const Program& p, int32_t max_steps,
                    int32_t seg_steps,
                    const flexifault::Spec& fs = flexifault::Spec{},
                    const flexifault::LaneConsts& fc =
                        flexifault::LaneConsts{}) {
  for (int32_t k = 0; k < seg_steps; ++k) {
    if (s.halted || s.n_instr >= max_steps) break;
    step<TIMING>(s, p);
    if constexpr (FAULT != flexifault::NONE) {
      if (!s.halted)
        flexifault::apply<FAULT>(fs, fc, s.regs, s.regs_stride, p.mem,
                                 p.mlen, s.pc, s.n_instr);
    }
  }
}

}  // namespace rv32e
