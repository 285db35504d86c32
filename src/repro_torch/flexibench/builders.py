"""Shared RV32E assembly macro-builders for FlexiBench workloads:
matvec (software-mul), decision-tree walk, argmax, popcount.

Register conventions (callers must respect):
  __mul clobbers a0, a1, t0, t1, t2.
  matvec uses s0, s1, a2, a3, a4, a5 (+ mul's).
  tree_walk uses t0, t1, t2, a2, a3, a4 and returns the leaf in a3.
"""
from __future__ import annotations

import numpy as np

from repro_torch.flexibits.asm import Asm


def wrap32(v):
    """Wrap any integer array/scalar to int32 two's-complement."""
    return (np.asarray(v, np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .astype(np.int32)


def mulw(a, b):
    """int32 wrap-around multiply (matches the software mul routine)."""
    return wrap32(np.asarray(a, np.int64) * np.asarray(b, np.int64))


def emit_matvec(a: Asm, *, w_off: int, b_off: int, x_addr: int, y_addr: int,
                rows: int, cols: int, shift: int, relu: bool):
    """y[i] = max(0, (b[i] + sum_j W[i,j] x[j]) >> shift)   (relu optional)

    W row-major int32 words at const offset w_off; bias at b_off;
    x at byte address x_addr (RAM); y at byte address y_addr (RAM).
    """
    li, lab = a.li, a.uniq
    loop_i, loop_j, after_relu = lab("mv_i"), lab("mv_j"), lab("mv_r")
    a.li(a.s0, 0)                        # i
    a.la_const(a.a2, w_off)              # W ptr (advances)
    a.label(loop_i)
    # acc = bias[i]
    a.la_const(a.t0, b_off)
    a.slli(a.t1, a.s0, 2)
    a.add(a.t0, a.t0, a.t1)
    a.lw(a.a3, a.t0, 0)
    a.li(a.a4, x_addr)                   # x ptr
    a.li(a.s1, cols)                     # j counter
    a.label(loop_j)
    a.lw(a.a0, a.a4, 0)
    a.lw(a.a1, a.a2, 0)
    a.call("__mul")
    a.add(a.a3, a.a3, a.a0)
    a.addi(a.a4, a.a4, 4)
    a.addi(a.a2, a.a2, 4)
    a.addi(a.s1, a.s1, -1)
    a.bne(a.s1, a.zero, loop_j)
    if shift:
        a.srai(a.a3, a.a3, shift)
    if relu:
        a.bge(a.a3, a.zero, after_relu)
        a.li(a.a3, 0)
        a.label(after_relu)
    # y[i] = acc
    a.li(a.a5, y_addr)
    a.slli(a.t1, a.s0, 2)
    a.add(a.a5, a.a5, a.t1)
    a.sw(a.a3, a.a5, 0)
    a.addi(a.s0, a.s0, 1)
    a.li(a.t1, rows)
    a.blt(a.s0, a.t1, loop_i)


def matvec_ref(W, b, x, shift, relu):
    """Bit-exact reference for emit_matvec (int32 wrap + arithmetic shift).

    x may be (cols,) or (batch, cols); result broadcasts accordingly.
    """
    x = np.asarray(x)
    acc = np.broadcast_to(
        wrap32(b), x.shape[:-1] + (W.shape[0],)).astype(np.int64)
    for j in range(W.shape[1]):
        acc = wrap32(acc + mulw(W[:, j], x[..., j:j + 1])).astype(np.int64)
    acc = wrap32(acc) >> shift
    if relu:
        acc = np.maximum(acc, 0)
    return wrap32(acc)


def emit_argmax(a: Asm, *, y_addr: int, n: int):
    """a3 <- argmax(y[0..n-1]); ties -> first. Clobbers t0,t1,t2,a2,a4."""
    loop, skip = a.uniq("am"), a.uniq("am_s")
    a.li(a.a3, 0)                        # best idx
    a.li(a.a4, y_addr)
    a.lw(a.t2, a.a4, 0)                  # best val
    a.li(a.t0, 1)                        # i
    a.label(loop)
    a.slli(a.t1, a.t0, 2)
    a.add(a.t1, a.t1, a.a4)
    a.lw(a.a2, a.t1, 0)
    a.bge(a.t2, a.a2, skip)              # best >= y[i] -> keep
    a.mv(a.a3, a.t0)
    a.mv(a.t2, a.a2)
    a.label(skip)
    a.addi(a.t0, a.t0, 1)
    a.li(a.t1, n)
    a.blt(a.t0, a.t1, loop)


def pack_tree(nodes):
    """nodes: list of (feat, thresh, left, right); leaves are encoded as
    ~value (negative). Returns flat int32 table (4 words per node)."""
    flat = []
    for f, t, l, r in nodes:
        flat += [f, t, l, r]
    return np.asarray(flat, np.int32)


def emit_tree_walk(a: Asm, *, table_off: int, x_addr: int, depth: int = 3):
    """Walk one packed tree; leaf value (small int) left in a3.

    next = (x[feat] <= thresh) ? left : right; negative next = ~leaf.
    `depth` bounds the internal levels of the packed table (every
    FlexiBench tree is 3 deep) — the walk is data-dependent, so the
    FlexiLint WCET needs the bound as an annotation (DESIGN.md §9.11).
    """
    loop, right, done = a.uniq("tw"), a.uniq("tw_r"), a.uniq("tw_d")
    a.li(a.a3, 0)                        # node idx
    a.loop_bound(loop, depth)
    a.label(loop)
    a.la_const(a.t0, table_off)
    a.slli(a.t1, a.a3, 4)                # node * 16 bytes
    a.add(a.t0, a.t0, a.t1)
    a.lw(a.t1, a.t0, 0)                  # feat
    a.slli(a.t1, a.t1, 2)
    a.li(a.a4, x_addr)
    a.add(a.t1, a.t1, a.a4)
    a.lw(a.t2, a.t1, 0)                  # x[feat]
    a.lw(a.a2, a.t0, 4)                  # thresh
    a.blt(a.a2, a.t2, right)             # thresh < x -> right
    a.lw(a.a3, a.t0, 8)                  # left
    a.j(loop + "_chk")
    a.label(right)
    a.lw(a.a3, a.t0, 12)                 # right
    a.label(loop + "_chk")
    a.bge(a.a3, a.zero, loop)
    a.xori(a.a3, a.a3, -1)               # leaf = ~next
    a.label(done)


def tree_walk_ref(table, x):
    """Reference for emit_tree_walk. table: flat int32; x: (features,)."""
    node = 0
    while node >= 0:
        f, t, l, r = (int(table[4 * node + k]) for k in range(4))
        node = l if int(x[f]) <= t else r
    return np.int32(~node)


def emit_popcount(a: Asm):
    """Routine __popcnt: a0 <- popcount(a0). Clobbers t0, t1."""
    a.label("__popcnt")
    a.mv(a.t0, a.a0)
    a.li(a.a0, 0)
    loop, done = "__pc_loop", "__pc_done"
    # one iteration per set bit + the final zero test
    a.loop_bound(loop, 33)
    a.label(loop)
    a.beq(a.t0, a.zero, done)
    a.addi(a.t1, a.t0, -1)
    a.and_(a.t0, a.t0, a.t1)
    a.addi(a.a0, a.a0, 1)
    a.j(loop)
    a.label(done)
    a.ret()
