// iss_segment_banked on Hopper: up to seg_steps RV32E steps for every lane
// of a packed pool, each lane on its own bank program, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/iss_stepper.py::
// iss_segment_banked (body _segment_kernel / _step_tile), with the timing
// tally and the fault mode (none, transient, stuck, dead) as template
// parameters. The `faults` variant (iss_stepper.py:152-160 and :306-318)
// takes two more per-lane inputs, the lane's fault key (uint32 bits) and
// its retry epoch, and the schedule (threshold, always, the enabled
// targets) as launch arguments; the per-lane transform is flexifault.cuh.
//
// Design. Blocks of 128 threads, four warps. Thread l of warp w steps lane
// w * kLanesPerWarp + l while l < kLanesPerWarp; the warp's other threads
// exit at once. A warp's step takes as long as the distinct paths its
// lanes take through the step's switch, and the lanes of a pool diverge
// on their programs and their data, so a warp of 8 lanes retires the
// pool faster than one of 32 (measured on one H100: PERF.md, with
// scripts/segment_lanes.py); 16,384 lanes fill 512 blocks, about four an
// SM on all 132. A live lane loads its 16 registers and 8 mix counters
// into shared memory ([index][thread], so a warp's lanes hit distinct
// banks) and its pc and counters into registers once, steps until it
// stops being live or the segment ends, and writes everything back once.
// The per-lane step is rv32e_step.cuh, which the CPU tests also compile
// with g++.
//
// What bounds it. Not bytes: the state is read and written once per
// segment (at the main path's shapes, 16,384 lanes x 2,824 memory words,
// ~370 MB both ways, ~0.1 ms at 3.35 TB/s) while a segment retires up to
// 4,096 dependent steps per lane. Each step is a chain of dependent integer
// work and up to two memory round trips (the fetch, and a load or store),
// so the kernel is bound by latency, integer issue and divergence.
//
// The faults variant adds, per live step, one hash of the lane's constant
// key and n_instr and a compare; only a step that fires hashes twice more
// and flips a bit: in the shared-memory register row, in the pc, or as one
// read-modify-write of the drawn word in the lane's memory row. The
// per-lane constants are hashed once, before the loop.
//
// The memory row stays in device memory, indexed directly: at up to 2,824
// words (11 KB) a lane, a useful tile's rows do not fit in the 227 KB of
// shared memory a block can use. The bank is read through the read-only
// path (__ldg). Nothing is allocated here; the state is updated in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flexifault.cuh"
#include "rv32e_step.cuh"

namespace {

constexpr int kBlock = 128;
// lanes a warp steps; a compile-time constant (scripts/segment_lanes.py
// builds other values to measure them)
#ifndef ISS_LANES_PER_WARP
#define ISS_LANES_PER_WARP 8
#endif
constexpr int kLanesPerWarp = ISS_LANES_PER_WARP;
static_assert(kLanesPerWarp >= 1 && kLanesPerWarp <= 32,
              "ISS_LANES_PER_WARP must be 1..32");
constexpr int kBlockLanes = kBlock / 32 * kLanesPerWarp;

template <bool TIMING, int FAULT>
__global__ void __launch_bounds__(kBlock) iss_segment_kernel(
    const int32_t* __restrict__ bank, int32_t n_progs, int32_t bank_width,
    const int32_t* __restrict__ code_len, const int32_t* __restrict__ mem_len,
    const int32_t* __restrict__ cost, const int32_t* __restrict__ prog_id,
    const int32_t* __restrict__ max_steps, int32_t* __restrict__ regs,
    int32_t* __restrict__ pc, int32_t* __restrict__ mem, int32_t mem_words,
    uint8_t* __restrict__ halted, int32_t* __restrict__ n_instr,
    int32_t* __restrict__ n_two, int32_t* __restrict__ mix,
    int32_t* __restrict__ n_cycles, int32_t n_lanes, int32_t seg_steps,
    const uint32_t* __restrict__ lane_key, const int32_t* __restrict__ epoch,
    flexifault::Spec fspec) {
  __shared__ int32_t s_regs[16 * kBlock];
  __shared__ int32_t s_mix[rv32e::N_MIX * kBlock];
  const int t = threadIdx.x;
  if (t % 32 >= kLanesPerWarp) return;
  const int lane = blockIdx.x * kBlockLanes + t / 32 * kLanesPerWarp + t % 32;
  if (lane >= n_lanes) return;

  const int32_t budget = max_steps[lane];
  rv32e::Lane s;
  s.halted = halted[lane] != 0;
  s.n_instr = n_instr[lane];
  // a lane that is not live takes no step this segment: nothing changes
  if (s.halted || s.n_instr >= budget) return;

  const size_t row = static_cast<size_t>(lane);
  for (int r = 0; r < 16; ++r) s_regs[r * kBlock + t] = regs[row * 16 + r];
  for (int c = 0; c < rv32e::N_MIX; ++c)
    s_mix[c * kBlock + t] = mix[row * rv32e::N_MIX + c];
  s.regs = s_regs + t;
  s.regs_stride = kBlock;
  s.mix = s_mix + t;
  s.mix_stride = kBlock;
  s.pc = pc[lane];
  s.n_two = n_two[lane];
  s.n_cycles = n_cycles[lane];

  // prog_id indexes the bank like a clamping gather would
  const int32_t p = rv32e::clampi(prog_id[lane], 0, n_progs - 1);
  rv32e::Program prog;
  prog.code = bank + static_cast<size_t>(p) * bank_width;
  prog.clen = code_len[p];
  prog.mem = mem + row * mem_words;
  prog.mlen = mem_len[p];
  prog.cost = TIMING ? cost + static_cast<size_t>(p) * rv32e::N_COST : nullptr;

  flexifault::LaneConsts fc{};
  if constexpr (FAULT != flexifault::NONE)
    fc = flexifault::lane_consts<FAULT>(fspec, lane_key[lane], epoch[lane]);
  rv32e::run_lane<TIMING, FAULT>(s, prog, budget, seg_steps, fspec, fc);

  for (int r = 0; r < 16; ++r) regs[row * 16 + r] = s_regs[r * kBlock + t];
  for (int c = 0; c < rv32e::N_MIX; ++c)
    mix[row * rv32e::N_MIX + c] = s_mix[c * kBlock + t];
  pc[lane] = s.pc;
  halted[lane] = s.halted ? 1 : 0;
  n_instr[lane] = s.n_instr;
  n_two[lane] = s.n_two;
  n_cycles[lane] = s.n_cycles;
}

}  // namespace

// Plain C entry for ctypes: every pointer is a device pointer, `stream` a
// cudaStream_t. `fault_mode` is flexifault::NONE (0; `lane_key` and
// `epoch` unused and may be null), TRANSIENT (1), STUCK (2) or DEAD (3);
// target0..2 are the first `n_targets` enabled transient targets
// (flexifault::REGS, MEM, PC). Returns cudaGetLastError() after the
// launch (0 = success), or cudaErrorInvalidValue (1) for a fault mode or
// target count out of range.
extern "C" int iss_segment_banked_launch(
    const void* bank, int n_progs, int bank_width, const void* code_len,
    const void* mem_len, const void* cost, int timing, const void* prog_id,
    const void* max_steps, void* regs, void* pc, void* mem, int mem_words,
    void* halted, void* n_instr, void* n_two, void* mix, void* n_cycles,
    int n_lanes, int seg_steps, int fault_mode, const void* lane_key,
    const void* epoch, unsigned int threshold, int always, int n_targets,
    int target0, int target1, int target2, void* stream) {
  if (fault_mode < flexifault::NONE || fault_mode > flexifault::DEAD ||
      (fault_mode == flexifault::TRANSIENT &&
       (n_targets < 1 || n_targets > 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes <= 0 || seg_steps <= 0) return 0;
  const dim3 grid((n_lanes + kBlockLanes - 1) / kBlockLanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const flexifault::Spec fs{threshold, always, n_targets,
                            {target0, target1, target2}};
  // one instantiation per (timing, fault mode)
  auto go = [&](auto timing_c, auto fault_c) {
    iss_segment_kernel<decltype(timing_c)::value, decltype(fault_c)::value>
        <<<grid, kBlock, 0, st>>>(
            static_cast<const int32_t*>(bank), n_progs, bank_width,
            static_cast<const int32_t*>(code_len),
            static_cast<const int32_t*>(mem_len),
            static_cast<const int32_t*>(cost),
            static_cast<const int32_t*>(prog_id),
            static_cast<const int32_t*>(max_steps),
            static_cast<int32_t*>(regs), static_cast<int32_t*>(pc),
            static_cast<int32_t*>(mem), mem_words,
            static_cast<uint8_t*>(halted), static_cast<int32_t*>(n_instr),
            static_cast<int32_t*>(n_two), static_cast<int32_t*>(mix),
            static_cast<int32_t*>(n_cycles), n_lanes, seg_steps,
            static_cast<const uint32_t*>(lane_key),
            static_cast<const int32_t*>(epoch), fs);
  };
  auto by_mode = [&](auto timing_c) {
    switch (fault_mode) {
      case flexifault::TRANSIENT:
        go(timing_c, std::integral_constant<int, flexifault::TRANSIENT>{});
        break;
      case flexifault::STUCK:
        go(timing_c, std::integral_constant<int, flexifault::STUCK>{});
        break;
      case flexifault::DEAD:
        go(timing_c, std::integral_constant<int, flexifault::DEAD>{});
        break;
      default:
        go(timing_c, std::integral_constant<int, flexifault::NONE>{});
        break;
    }
  };
  if (timing)
    by_mode(std::true_type{});
  else
    by_mode(std::false_type{});
  return static_cast<int>(cudaGetLastError());
}
