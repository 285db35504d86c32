// iss_refill on Hopper: swap staged items into the lanes that take one.
//
// Replaces the TPU kernel src/repro/kernels/iss_stepper.py::iss_refill
// (body _refill_kernel). For a lane with take[lane], it zeroes regs, pc,
// halted and the counters, and loads the staged memory row, prog_id and
// max_steps of staged row src[lane]; every other lane passes through.
// The take/src assignment (a pool-wide cumsum) is computed before the
// launch, as in the reference.
//
// Design. One block per lane; a lane that does not take returns at once,
// a taking lane's threads stride over its memory row (consecutive threads,
// consecutive words: coalesced), and one thread writes the per-lane
// scalars. The state is updated in place, the counterpart of the TPU
// kernel's input_output_aliases. What bounds it is bytes: each taking lane
// reads one staged row and writes one lane row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock) iss_refill_kernel(
    const uint8_t* __restrict__ take, const int32_t* __restrict__ src,
    const int32_t* __restrict__ staged_mems,
    const int32_t* __restrict__ staged_prog,
    const int32_t* __restrict__ staged_ms, int32_t n_rows,
    int32_t* __restrict__ regs, int32_t* __restrict__ pc,
    int32_t* __restrict__ mem, int32_t mem_words,
    uint8_t* __restrict__ halted, int32_t* __restrict__ n_instr,
    int32_t* __restrict__ n_two, int32_t* __restrict__ mix,
    int32_t* __restrict__ n_cycles, int32_t* __restrict__ prog_id,
    int32_t* __restrict__ max_steps) {
  const int lane = blockIdx.x;
  if (!take[lane]) return;
  // src indexes the staged batch like a clamping gather would
  int32_t s = src[lane];
  s = s < 0 ? 0 : (s > n_rows - 1 ? n_rows - 1 : s);
  const int32_t* from = staged_mems + static_cast<size_t>(s) * mem_words;
  int32_t* to = mem + static_cast<size_t>(lane) * mem_words;
  for (int w = threadIdx.x; w < mem_words; w += kBlock) to[w] = __ldg(from + w);
  if (threadIdx.x < 16) regs[static_cast<size_t>(lane) * 16 + threadIdx.x] = 0;
  if (threadIdx.x < 8) mix[static_cast<size_t>(lane) * 8 + threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    pc[lane] = 0;
    halted[lane] = 0;
    n_instr[lane] = 0;
    n_two[lane] = 0;
    n_cycles[lane] = 0;
    prog_id[lane] = __ldg(staged_prog + s);
    max_steps[lane] = __ldg(staged_ms + s);
  }
}

}  // namespace

// Plain C entry for ctypes: every pointer is a device pointer, `stream` a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int iss_refill_launch(
    const void* take, const void* src, const void* staged_mems,
    const void* staged_prog, const void* staged_ms, int n_rows, void* regs,
    void* pc, void* mem, int mem_words, void* halted, void* n_instr,
    void* n_two, void* mix, void* n_cycles, void* prog_id, void* max_steps,
    int n_lanes, void* stream) {
  if (n_lanes <= 0 || n_rows <= 0) return 0;
  iss_refill_kernel<<<n_lanes, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(take), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(staged_mems),
      static_cast<const int32_t*>(staged_prog),
      static_cast<const int32_t*>(staged_ms), n_rows,
      static_cast<int32_t*>(regs), static_cast<int32_t*>(pc),
      static_cast<int32_t*>(mem), mem_words, static_cast<uint8_t*>(halted),
      static_cast<int32_t*>(n_instr), static_cast<int32_t*>(n_two),
      static_cast<int32_t*>(mix), static_cast<int32_t*>(n_cycles),
      static_cast<int32_t*>(prog_id), static_cast<int32_t*>(max_steps));
  return static_cast<int>(cudaGetLastError());
}
