"""The 11 FlexiBench workloads (paper Table 2), each as RV32E assembly +
bit-exact numpy reference + synthetic dataset generator.

Deployment metadata (lifetime, example task frequency) follows Table 2; the
red-star frequencies are documented per workload. Quantization is integer
fixed-point throughout (RV32E has no FPU).
"""
from __future__ import annotations

import numpy as np

from repro_torch.flexibench import builders as B
from repro_torch.flexibench.base import (DAY_S, MONTH_S, WEEK_S, YEAR_S,
                                         Workload, register)
from repro_torch.flexibits.asm import Asm

RNG = np.random.default_rng  # all tables built with fixed seeds


# ===================================================================== WQ
def _build_wq():
    """Water Quality Monitoring: threshold checks (SDG #6)."""
    n_in, out = 3, 4
    a = Asm(vm_reserved=4 * (n_in + 2))
    # ok = (650<=ph<=850) & (do>=500) & (tds<=500)
    fail = a.uniq("fail")
    done = a.uniq("done")
    a.lw(a.a2, a.zero, 0)            # ph x100
    a.li(a.t0, 650)
    a.blt(a.a2, a.t0, fail)
    a.li(a.t0, 850)
    a.blt(a.t0, a.a2, fail)
    a.lw(a.a2, a.zero, 4)            # do x100
    a.li(a.t0, 500)
    a.blt(a.a2, a.t0, fail)
    a.lw(a.a2, a.zero, 8)            # tds
    a.li(a.t0, 500)
    a.blt(a.t0, a.a2, fail)
    a.li(a.a3, 1)
    a.j(done)
    a.label(fail)
    a.li(a.a3, 0)
    a.label(done)
    a.sw(a.a3, a.zero, 4 * out)
    a.halt()
    prog = a.assemble()

    def gen(rng, n):
        x = np.stack([rng.integers(500, 1000, n),
                      rng.integers(300, 900, n),
                      rng.integers(100, 900, n)], -1)
        return x.astype(np.int32)

    def ref(x):
        ok = ((x[:, 0] >= 650) & (x[:, 0] <= 850) & (x[:, 1] >= 500)
              & (x[:, 2] <= 500))
        return ok.astype(np.int32)

    return register(Workload(
        key="WQ", name="Water Quality Monitoring", sdg="#6 Clean Water",
        algorithm="Thresholds", lifetime_s=1 * DAY_S, execs_per_day=24,
        program=prog, mem_words=64, n_inputs=n_in, gen_inputs=gen, ref=ref,
        out_addr=out, max_steps=20_000))


# ===================================================================== MC
def _mc_trees():
    rng = RNG(7)
    # two depth-3 trees (male/female), 4 e-nose features in 0..31,
    # leaves = malodor score 0..4
    def tree():
        nodes = []
        # complete depth-3: nodes 0..6, leaves at depth 3
        th = sorted(rng.integers(4, 28, 7))
        leaves = rng.integers(0, 5, 8)
        # node i children: internal until idx 3..6 whose children are leaves
        nodes.append((0, int(th[3]), 1, 2))
        nodes.append((1, int(th[1]), 3, 4))
        nodes.append((2, int(th[5]), 5, 6))
        for k in range(4):
            nodes.append((3, int(th[k if k < 3 else 6]),
                          ~int(leaves[2 * k]), ~int(leaves[2 * k + 1])))
        return nodes
    return B.pack_tree(tree()), B.pack_tree(tree())


def _build_mc():
    """Malodor Classification: 2 decision trees (SDG #12)."""
    t_m, t_f = _mc_trees()
    n_in, out = 5, 8                  # [gender, s0..s3]
    a = Asm(vm_reserved=4 * (n_in + 2))
    off_m = a.const_words(t_m)
    off_f = a.const_words(t_f)
    female = a.uniq("female")
    done = a.uniq("done")
    a.lw(a.t0, a.zero, 0)
    a.bne(a.t0, a.zero, female)
    B.emit_tree_walk(a, table_off=off_m, x_addr=4)
    a.j(done)
    a.label(female)
    B.emit_tree_walk(a, table_off=off_f, x_addr=4)
    a.label(done)
    a.sw(a.a3, a.zero, 4 * out)
    a.halt()
    prog = a.assemble()

    def gen(rng, n):
        return np.concatenate([rng.integers(0, 2, (n, 1)),
                               rng.integers(0, 32, (n, 4))],
                              -1).astype(np.int32)

    def ref(x):
        out_v = np.zeros(len(x), np.int32)
        for i, row in enumerate(x):
            tab = t_f if row[0] else t_m
            out_v[i] = B.tree_walk_ref(tab, row[1:])
        return out_v

    return register(Workload(
        key="MC", name="Malodor Classification", sdg="#12 Responsible Cons.",
        algorithm="Decision Tree", lifetime_s=4 * YEAR_S, execs_per_day=1,
        program=prog, mem_words=128, n_inputs=n_in, gen_inputs=gen, ref=ref,
        out_addr=out, max_steps=20_000))


# ===================================================================== FS
def _fs_model():
    """Quantized logistic-regression beef-spoilage model, 'trained' on the
    synthetic e-nose generative model (class means), Q8 weights."""
    rng = RNG(11)
    n_feat, n_cls = 10, 4            # fresh / ok / stale / spoiled
    means = np.linspace(200, 1800, n_cls)[:, None] * \
        np.linspace(0.5, 1.5, n_feat)[None, :]
    W = np.round((means - means.mean(0)) / 8.0).astype(np.int32)
    # nearest-mean bias with the same 1/8 weight scale: b_c = -|mu_c|^2/16
    b = np.round(-(means * means).sum(1) / 16.0)
    return W, b.astype(np.int64).astype(np.int32), means


def _build_fs():
    W, b, means = _fs_model()
    n_in, y_addr_w = 10, 12
    out = y_addr_w + 4
    a = Asm(vm_reserved=4 * (n_in + 4 + 2))
    w_off = a.const_words(W.reshape(-1))
    b_off = a.const_words(b)
    B.emit_matvec(a, w_off=w_off, b_off=b_off, x_addr=0,
                  y_addr=4 * y_addr_w, rows=4, cols=10, shift=8, relu=False)
    B.emit_argmax(a, y_addr=4 * y_addr_w, n=4)
    a.sw(a.a3, a.zero, 4 * out)
    a.halt()
    a.emit_mul_routine()
    prog = a.assemble()

    def gen(rng, n):
        cls = rng.integers(0, 4, n)
        x = means[cls] + rng.normal(0, 350, (n, 10))
        return np.clip(np.round(x), 0, 4000).astype(np.int32)

    def ref(x):
        y = B.matvec_ref(W, b, x, 8, False)
        return np.argmax(y, -1).astype(np.int32)

    return register(Workload(
        key="FS", name="Food Spoilage Detection", sdg="#2 Zero Hunger",
        algorithm="Logistic Regression", lifetime_s=1 * WEEK_S,
        execs_per_day=24, program=prog, mem_words=128, n_inputs=n_in,
        gen_inputs=gen, ref=ref, out_addr=out, max_steps=200_000))


# ===================================================================== SI
def _si_refs():
    rng = RNG(13)
    n_ref = 20
    temp = rng.integers(10, 40, n_ref)
    moist = rng.integers(0, 100, n_ref)
    label = (moist < 45).astype(np.int32)      # dry -> pump on
    return np.stack([temp, moist, label], -1).astype(np.int32)


def _build_si():
    refs = _si_refs()
    n_ref = len(refs)
    n_in = 2
    # globals: best3 dist (words 4..6), best3 label (7..9)
    out = 10
    a = Asm(vm_reserved=4 * 12)
    r_off = a.const_words(refs.reshape(-1))
    big = 0x7FFFFFFF
    for k in range(3):
        a.li(a.t0, big)
        a.sw(a.t0, a.zero, 4 * (4 + k))
        a.sw(a.zero, a.zero, 4 * (7 + k))
    loop = a.uniq("si")
    a.li(a.s0, 0)                     # ref index
    a.label(loop)
    a.la_const(a.s1, r_off)
    a.slli(a.t1, a.s0, 2)
    a.add(a.t1, a.t1, a.s0)           # s0*5? no: 3 words per ref -> s0*12
    # compute s1 += s0*12: t1 = s0*4; t2 = s0*8; s1 += t1+t2
    a.slli(a.t1, a.s0, 2)
    a.slli(a.t2, a.s0, 3)
    a.add(a.s1, a.s1, a.t1)
    a.add(a.s1, a.s1, a.t2)
    # dt = x0 - ref_t ; dm = x1 - ref_m
    a.lw(a.a0, a.zero, 0)
    a.lw(a.t0, a.s1, 0)
    a.sub(a.a0, a.a0, a.t0)
    a.mv(a.a1, a.a0)
    a.call("__mul")                   # a0 = dt*dt
    a.mv(a.a2, a.a0)
    a.lw(a.a0, a.zero, 4)
    a.lw(a.t0, a.s1, 4)
    a.sub(a.a0, a.a0, a.t0)
    a.mv(a.a1, a.a0)
    a.call("__mul")                   # a0 = dm*dm
    a.add(a.a2, a.a2, a.a0)           # dist
    a.lw(a.a3, a.s1, 8)               # label
    # insertion into best3 (registers: a2 dist, a3 label)
    for k in range(3):
        nxt = a.uniq(f"si_ins{k}")
        a.lw(a.t0, a.zero, 4 * (4 + k))
        a.bge(a.a2, a.t0, nxt)        # dist >= best[k] -> next slot
        # shift down slots > k, insert at k
        for j in range(2, k, -1):
            a.lw(a.t1, a.zero, 4 * (4 + j - 1))
            a.sw(a.t1, a.zero, 4 * (4 + j))
            a.lw(a.t1, a.zero, 4 * (7 + j - 1))
            a.sw(a.t1, a.zero, 4 * (7 + j))
        a.sw(a.a2, a.zero, 4 * (4 + k))
        a.sw(a.a3, a.zero, 4 * (7 + k))
        a.j(a.uniq("si_done_ins") if False else f"__si_inserted_{k}")
        a.label(nxt)
    for k in range(3):
        a.label(f"__si_inserted_{k}")
    a.addi(a.s0, a.s0, 1)
    a.li(a.t0, n_ref)
    a.blt(a.s0, a.t0, loop)
    # majority vote of labels
    a.lw(a.t0, a.zero, 4 * 7)
    a.lw(a.t1, a.zero, 4 * 8)
    a.add(a.t0, a.t0, a.t1)
    a.lw(a.t1, a.zero, 4 * 9)
    a.add(a.t0, a.t0, a.t1)
    a.li(a.t1, 2)
    a.slt(a.a3, a.t0, a.t1)           # sum<2 -> 1? no: vote = sum>=2
    a.xori(a.a3, a.a3, 1)
    a.sw(a.a3, a.zero, 4 * out)
    a.halt()
    a.emit_mul_routine()
    prog = a.assemble()

    def gen(rng, n):
        return np.stack([rng.integers(10, 40, n),
                         rng.integers(0, 100, n)], -1).astype(np.int32)

    def ref(x):
        d = (B.mulw(x[:, None, 0] - refs[None, :, 0],
                    x[:, None, 0] - refs[None, :, 0]).astype(np.int64)
             + B.mulw(x[:, None, 1] - refs[None, :, 1],
                      x[:, None, 1] - refs[None, :, 1]))
        idx = np.argsort(d, axis=1, kind="stable")[:, :3]
        votes = refs[idx, 2].sum(1)
        return (votes >= 2).astype(np.int32)

    return register(Workload(
        key="SI", name="Smart Irrigation Control", sdg="#13 Climate Action",
        algorithm="KNN", lifetime_s=6 * MONTH_S, execs_per_day=1,
        program=prog, mem_words=128, n_inputs=n_in, gen_inputs=gen, ref=ref,
        out_addr=out, max_steps=200_000))


# ==================================================================== MLPs
def _quant_mlp(rng, dims, means):
    """Random-feature MLP 'trained' by class-mean projection; Q6 ints."""
    Ws, bs = [], []
    for i in range(len(dims) - 1):
        W = rng.normal(0, 1, (dims[i + 1], dims[i]))
        Ws.append(np.round(W * 8).astype(np.int32))
        bs.append(np.zeros(dims[i + 1], np.int32))
    return Ws, bs


def _build_mlp_workload(*, key, name, sdg, algorithm, lifetime_s,
                        execs_per_day, dims, in_range, seed, max_steps):
    rng = RNG(seed)
    Ws, bs = _quant_mlp(rng, dims, None)
    n_in = dims[0]
    # RAM layout: x (n_in), then ping/pong activation buffers
    buf0 = n_in
    buf1 = n_in + max(dims[1:])
    out = buf1 + max(dims[1:])
    a = Asm(vm_reserved=4 * (out + 2))
    offs = [(a.const_words(W.reshape(-1)), a.const_words(b))
            for W, b in zip(Ws, bs)]
    src = 0
    dst = buf0
    for li, ((w_off, b_off), W) in enumerate(zip(offs, Ws)):
        last = li == len(Ws) - 1
        B.emit_matvec(a, w_off=w_off, b_off=b_off, x_addr=4 * src,
                      y_addr=4 * dst, rows=W.shape[0], cols=W.shape[1],
                      shift=6, relu=not last)
        src, dst = dst, (buf1 if dst == buf0 else buf0)
    B.emit_argmax(a, y_addr=4 * src, n=dims[-1])
    a.sw(a.a3, a.zero, 4 * out)
    a.halt()
    a.emit_mul_routine()
    prog = a.assemble()

    def gen(rng2, n):
        return rng2.integers(-in_range, in_range,
                             (n, n_in)).astype(np.int32)

    def ref(x):
        h = x
        for li, (W, b) in enumerate(zip(Ws, bs)):
            h = B.matvec_ref(W, b, h, 6, li < len(Ws) - 1)
        return np.argmax(h, -1).astype(np.int32)

    return register(Workload(
        key=key, name=name, sdg=sdg, algorithm=algorithm,
        lifetime_s=lifetime_s, execs_per_day=execs_per_day, program=prog,
        mem_words=256, n_inputs=n_in, gen_inputs=gen, ref=ref,
        out_addr=out, max_steps=max_steps))


def _build_ct():
    """Cardiotocography: MLP 21-16-3 (SDG #3)."""
    return _build_mlp_workload(
        key="CT", name="Cardiotocography", sdg="#3 Good Health",
        algorithm="MLP", lifetime_s=9 * MONTH_S, execs_per_day=24 * 2,
        dims=(21, 16, 3), in_range=64, seed=17, max_steps=2_000_000)


def _build_pt():
    """Package Tracking: MLP 12-16-16-4 (SDG #9)."""
    return _build_mlp_workload(
        key="PT", name="Package Tracking", sdg="#9 Infrastructure",
        algorithm="MLP (2 hidden)", lifetime_s=3 * WEEK_S,
        execs_per_day=24 * 3, dims=(12, 16, 16, 4), in_range=64, seed=19,
        max_steps=2_000_000)


# ===================================================================== AD
def _ad_bloom():
    """Bloom filter populated with AF-like (rr, drr) pairs."""
    rng = RNG(23)
    table = np.zeros(8, np.int64)
    for _ in range(40):
        rr = int(rng.integers(20, 60))       # irregular RR (in samples)
        drr = int(rng.integers(-20, 20))
        for mul_a, mul_b in ((31, 7), (13, 3)):
            h = (rr * mul_a + drr * mul_b) & 255
            table[h >> 5] |= 1 << (h & 31)
    return np.int32(table & 0xFFFFFFFF).astype(np.int32), rng


def _build_ad():
    bloom, _ = _ad_bloom()
    n_samp = 80
    thr = 96
    n_in = n_samp
    out = n_samp + 8
    a = Asm(vm_reserved=4 * (out + 2))
    b_off = a.const_words(bloom)
    # globals: last_peak(word n+0), last_rr(n+1), af_count(n+2)
    gl = n_samp
    a.li(a.t0, -1)
    a.sw(a.t0, a.zero, 4 * (gl + 0))
    a.sw(a.zero, a.zero, 4 * (gl + 1))
    a.sw(a.zero, a.zero, 4 * (gl + 2))
    loop = a.uniq("ad")
    nxt = a.uniq("ad_n")
    a.li(a.s0, 1)                     # i = 1..n-2
    a.label(loop)
    a.slli(a.t0, a.s0, 2)
    a.lw(a.a2, a.t0, 0)               # x[i]
    a.li(a.t1, thr)
    a.blt(a.a2, a.t1, nxt)            # below threshold
    a.lw(a.t1, a.t0, -4)              # x[i-1]
    a.blt(a.a2, a.t1, nxt)
    a.lw(a.t1, a.t0, 4)               # x[i+1]
    a.blt(a.a2, a.t1, nxt)
    # peak at i: rr = i - last_peak
    a.lw(a.t1, a.zero, 4 * (gl + 0))
    a.sw(a.s0, a.zero, 4 * (gl + 0))
    a.li(a.t2, -1)
    a.beq(a.t1, a.t2, nxt)            # first peak: no rr yet
    a.sub(a.a2, a.s0, a.t1)           # rr
    a.lw(a.t1, a.zero, 4 * (gl + 1))  # last_rr
    a.sw(a.a2, a.zero, 4 * (gl + 1))
    a.beq(a.t1, a.zero, nxt)          # no previous rr
    a.sub(a.a4, a.a2, a.t1)           # drr
    # h1 = (rr*31 + drr*7) & 255 ; h2 = (rr*13 + drr*3) & 255
    checked = a.uniq("ad_chk")
    for mul_a, mul_b in ((31, 7), (13, 3)):
        a.li(a.a1, mul_a)
        a.mv(a.a0, a.a2)
        a.call("__mul")
        a.mv(a.a5, a.a0)
        a.li(a.a1, mul_b)
        a.mv(a.a0, a.a4)
        a.call("__mul")
        a.add(a.a5, a.a5, a.a0)
        a.andi(a.a5, a.a5, 255)
        # bit test
        a.srli(a.t1, a.a5, 5)
        a.slli(a.t1, a.t1, 2)
        a.la_const(a.t2, b_off)
        a.add(a.t1, a.t1, a.t2)
        a.lw(a.t1, a.t1, 0)
        a.andi(a.t2, a.a5, 31)
        a.srl(a.t1, a.t1, a.t2)
        a.andi(a.t1, a.t1, 1)
        a.beq(a.t1, a.zero, checked)  # bit clear -> not AF
    # both bits set -> af_count++
    a.lw(a.t1, a.zero, 4 * (gl + 2))
    a.addi(a.t1, a.t1, 1)
    a.sw(a.t1, a.zero, 4 * (gl + 2))
    a.label(checked)
    a.label(nxt)
    a.addi(a.s0, a.s0, 1)
    a.li(a.t0, n_samp - 1)
    a.blt(a.s0, a.t0, loop)
    a.lw(a.t0, a.zero, 4 * (gl + 2))
    a.sw(a.t0, a.zero, 4 * out)
    a.halt()
    a.emit_mul_routine()
    prog = a.assemble()

    def gen(rng, n):
        # synthetic ECG: baseline noise + peaks at irregular intervals
        x = rng.integers(0, 40, (n, n_samp))
        for i in range(n):
            pos = 2
            while pos < n_samp - 2:
                x[i, pos] = rng.integers(100, 127)
                pos += int(rng.integers(15, 60))
        return x.astype(np.int32)

    def ref(x):
        outv = np.zeros(len(x), np.int32)
        for i, row in enumerate(x):
            last_peak, last_rr, count = -1, 0, 0
            for j in range(1, n_samp - 1):
                if row[j] >= thr and row[j] >= row[j - 1] \
                        and row[j] >= row[j + 1]:
                    if last_peak >= 0:
                        rr = j - last_peak
                        if last_rr != 0:
                            drr = rr - last_rr
                            h1 = (rr * 31 + drr * 7) & 255
                            h2 = (rr * 13 + drr * 3) & 255
                            if ((bloom[h1 >> 5] >> (h1 & 31)) & 1) and \
                               ((bloom[h2 >> 5] >> (h2 & 31)) & 1):
                                count += 1
                        last_rr = rr
                    last_peak = j
            outv[i] = count
        return outv

    return register(Workload(
        key="AD", name="Arrhythmia Detection", sdg="#3 Good Health",
        algorithm="Bloom Filter", lifetime_s=2 * WEEK_S,
        execs_per_day=24 * 60 * 6, program=prog, mem_words=256,
        n_inputs=n_in, gen_inputs=gen, ref=ref, out_addr=out,
        max_steps=2_000_000,
        feasible_note="paper: infeasible on all cores at real-time rates"))


# =================================================================== trees
def _forest(rng, n_trees, n_feat, feat_range, leaf_vals):
    tables = []
    for _ in range(n_trees):
        th = rng.integers(feat_range // 4, 3 * feat_range // 4, 7)
        fs = rng.integers(0, n_feat, 7)
        lv = rng.choice(leaf_vals, 8)
        nodes = [
            (int(fs[0]), int(th[0]), 1, 2),
            (int(fs[1]), int(th[1]), 3, 4),
            (int(fs[2]), int(th[2]), 5, 6),
            (int(fs[3]), int(th[3]), ~int(lv[0]), ~int(lv[1])),
            (int(fs[4]), int(th[4]), ~int(lv[2]), ~int(lv[3])),
            (int(fs[5]), int(th[5]), ~int(lv[4]), ~int(lv[5])),
            (int(fs[6]), int(th[6]), ~int(lv[6]), ~int(lv[7])),
        ]
        tables.append(B.pack_tree(nodes))
    return tables


def _build_forest_workload(*, key, name, sdg, algorithm, lifetime_s,
                           execs_per_day, n_trees, n_feat, feat_range,
                           leaf_vals, reduce_, seed, out_levels=None):
    rng = RNG(seed)
    tables = _forest(rng, n_trees, n_feat, feat_range, leaf_vals)
    n_in = n_feat
    acc_w = n_in          # accumulator word
    out = n_in + 1
    a = Asm(vm_reserved=4 * (out + 2))
    offs = [a.const_words(t) for t in tables]
    a.sw(a.zero, a.zero, 4 * acc_w)
    for off in offs:
        B.emit_tree_walk(a, table_off=off, x_addr=0)
        a.lw(a.t0, a.zero, 4 * acc_w)
        a.add(a.t0, a.t0, a.a3)
        a.sw(a.t0, a.zero, 4 * acc_w)
    a.lw(a.a2, a.zero, 4 * acc_w)
    if reduce_ == "majority":
        a.li(a.t0, n_trees // 2)
        a.slt(a.a3, a.t0, a.a2)       # sum > n/2
    else:                             # bucket by thresholds
        th = out_levels
        a.li(a.a3, 0)
        for t in th:
            a.li(a.t0, t)
            a.slt(a.t0, a.t0, a.a2)   # sum > t
            a.add(a.a3, a.a3, a.t0)
    a.sw(a.a3, a.zero, 4 * out)
    a.halt()
    prog = a.assemble()

    def gen(rng2, n):
        return rng2.integers(0, feat_range, (n, n_feat)).astype(np.int32)

    def ref(x):
        outv = np.zeros(len(x), np.int32)
        for i, row in enumerate(x):
            s = sum(int(B.tree_walk_ref(t, row)) for t in tables)
            if reduce_ == "majority":
                outv[i] = 1 if s > n_trees // 2 else 0
            else:
                outv[i] = sum(1 for t in out_levels if s > t)
        return outv

    return register(Workload(
        key=key, name=name, sdg=sdg, algorithm=algorithm,
        lifetime_s=lifetime_s, execs_per_day=execs_per_day, program=prog,
        mem_words=128, n_inputs=n_in, gen_inputs=gen, ref=ref,
        out_addr=out, max_steps=2_000_000))


def _build_hc():
    """HVAC Control: random forest, 100 trees (SDG #7)."""
    return _build_forest_workload(
        key="HC", name="HVAC Control", sdg="#7 Clean Energy",
        algorithm="Random Forest (100 trees)", lifetime_s=20 * YEAR_S,
        execs_per_day=24 * 4, n_trees=100, n_feat=5, feat_range=1024,
        leaf_vals=[0, 1], reduce_="majority", seed=29)


def _build_ap():
    """Air Pollution Monitoring: XGBoost-style additive trees (SDG #11)."""
    return _build_forest_workload(
        key="AP", name="Air Pollution Monitoring",
        sdg="#11 Sustainable Cities", algorithm="XGBoost (50 trees)",
        lifetime_s=4 * YEAR_S, execs_per_day=24, n_trees=50, n_feat=6,
        feat_range=1024, leaf_vals=[0, 1, 2, 3, 4], reduce_="bucket",
        seed=31, out_levels=[20, 40, 60, 80, 100])


# ===================================================================== GR
def _gr_refs():
    rng = RNG(37)
    return rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint64
                        ).astype(np.int64).astype(np.int32) \
        if False else np.int32(rng.integers(-2**31, 2**31, (5, 8)))


def _build_gr():
    refs = _gr_refs()                 # 5 gestures x 8 words (256 bits)
    n_in = 8
    # globals: best_sim, best_idx
    out = n_in + 2
    a = Asm(vm_reserved=4 * (out + 2))
    r_off = a.const_words(refs.reshape(-1))
    a.li(a.s0, 0)                     # gesture g
    a.li(a.a4, -1)                    # best sim
    a.li(a.a5, 0)                     # best idx
    gloop = a.uniq("gr_g")
    wloop = a.uniq("gr_w")
    skip = a.uniq("gr_s")
    a.label(gloop)
    a.li(a.a2, 0)                     # sim accumulator -> use RAM? regs ok
    a.li(a.s1, 0)                     # word w
    a.label(wloop)
    # t0 = x[w] ^ ref[g*8+w]; popcount(~t0) = 32 - popcount(t0)
    a.slli(a.t0, a.s1, 2)
    a.lw(a.t1, a.t0, 0)               # x[w]
    a.la_const(a.t2, r_off)
    a.slli(a.a0, a.s0, 5)             # g*32 bytes
    a.add(a.t2, a.t2, a.a0)
    a.slli(a.a0, a.s1, 2)
    a.add(a.t2, a.t2, a.a0)
    a.lw(a.t2, a.t2, 0)               # ref word
    a.xor(a.a0, a.t1, a.t2)
    a.sw(a.a2, a.zero, 4 * (n_in + 0))   # save sim (popcnt clobbers)
    a.call("__popcnt")
    a.lw(a.a2, a.zero, 4 * (n_in + 0))
    a.li(a.t0, 32)
    a.sub(a.t0, a.t0, a.a0)           # matching bits
    a.add(a.a2, a.a2, a.t0)
    a.addi(a.s1, a.s1, 1)
    a.li(a.t0, 8)
    a.blt(a.s1, a.t0, wloop)
    # update best
    a.bge(a.a4, a.a2, skip)
    a.mv(a.a4, a.a2)
    a.mv(a.a5, a.s0)
    a.label(skip)
    a.addi(a.s0, a.s0, 1)
    a.li(a.t0, 5)
    a.blt(a.s0, a.t0, gloop)
    a.sw(a.a5, a.zero, 4 * out)
    a.halt()
    B.emit_popcount(a)
    prog = a.assemble()

    def gen(rng, n):
        # flip a few bits of a random reference gesture
        g = rng.integers(0, 5, n)
        x = refs[g].astype(np.int64)
        for i in range(n):
            for _ in range(int(rng.integers(0, 20))):
                w = int(rng.integers(0, 8))
                b = int(rng.integers(0, 32))
                x[i, w] = int(x[i, w]) ^ (1 << b)
        return B.wrap32(x)

    def ref(x):
        xo = np.asarray(x, np.int64) & 0xFFFFFFFF
        ro = refs.astype(np.int64) & 0xFFFFFFFF
        xor = xo[:, None, :].astype(np.int64) ^ ro[None, :, :]
        pc = np.zeros(xor.shape[:2], np.int64)
        for w in range(8):
            v = xor[:, :, w]
            cnt = np.zeros_like(v)
            for _ in range(32):
                cnt += v & 1
                v >>= 1
            pc += 32 - cnt
        return np.argmax(pc, -1).astype(np.int32)

    return register(Workload(
        key="GR", name="Gesture Recognition", sdg="#10 Reduced Inequality",
        algorithm="Cosine Similarity (binary)", lifetime_s=2 * YEAR_S,
        execs_per_day=24 * 60 * 60, program=prog, mem_words=128,
        n_inputs=n_in, gen_inputs=gen, ref=ref, out_addr=out,
        max_steps=2_000_000,
        feasible_note="paper: infeasible on all cores at sub-second rates"))


# ===================================================================== TT
def _tt_tables():
    n = 32
    k = 8
    ang = 2 * np.pi * np.outer(np.arange(k), np.arange(n)) / n
    cos = np.round(np.cos(ang) * 127).astype(np.int32)
    sin = np.round(-np.sin(ang) * 127).astype(np.int32)
    return cos, sin


def _build_tt():
    cos, sin = _tt_tables()
    n, k = 32, 8
    n_in = n
    # globals: re, im ; output byte
    out = n_in + 4
    a = Asm(vm_reserved=4 * (out + 2))
    c_off = a.const_words(cos.reshape(-1))
    s_off = a.const_words(sin.reshape(-1))
    thr_hi = 1 << 24
    a.sw(a.zero, a.zero, 4 * (n_in + 2))      # demod byte
    for kk in range(k):
        # re/im accumulate
        a.sw(a.zero, a.zero, 4 * (n_in + 0))
        a.sw(a.zero, a.zero, 4 * (n_in + 1))
        loop = a.uniq(f"tt{kk}")
        a.li(a.s0, 0)
        a.label(loop)
        a.slli(a.t0, a.s0, 2)
        a.lw(a.a2, a.t0, 0)                   # x[n]
        for tab_off, acc_w in ((c_off, n_in + 0), (s_off, n_in + 1)):
            a.la_const(a.t1, tab_off + kk * n)
            a.slli(a.t2, a.s0, 2)
            a.add(a.t1, a.t1, a.t2)
            a.lw(a.a1, a.t1, 0)
            a.mv(a.a0, a.a2)
            a.call("__mul")
            a.lw(a.t1, a.zero, 4 * acc_w)
            a.add(a.t1, a.t1, a.a0)
            a.sw(a.t1, a.zero, 4 * acc_w)
        a.addi(a.s0, a.s0, 1)
        a.li(a.t0, n)
        a.blt(a.s0, a.t0, loop)
        # mag2 = re*re + im*im
        a.lw(a.a0, a.zero, 4 * (n_in + 0))
        a.mv(a.a1, a.a0)
        a.call("__mul")
        a.mv(a.a2, a.a0)
        a.lw(a.a0, a.zero, 4 * (n_in + 1))
        a.mv(a.a1, a.a0)
        a.call("__mul")
        a.add(a.a2, a.a2, a.a0)
        # bit kk = mag2 > thr
        a.li(a.t0, thr_hi)
        a.slt(a.t0, a.t0, a.a2)
        a.slli(a.t0, a.t0, kk)
        a.lw(a.t1, a.zero, 4 * (n_in + 2))
        a.or_(a.t1, a.t1, a.t0)
        a.sw(a.t1, a.zero, 4 * (n_in + 2))
    a.lw(a.t0, a.zero, 4 * (n_in + 2))
    a.sw(a.t0, a.zero, 4 * out)
    a.halt()
    a.emit_mul_routine()
    prog = a.assemble()

    def gen(rng, nn):
        # modulate a random byte: sum of carriers for set bits
        byte = rng.integers(0, 256, nn)
        t = np.arange(n)
        x = np.zeros((nn, n))
        for i in range(nn):
            for b in range(8):
                if (byte[i] >> b) & 1:
                    x[i] += 90 * np.cos(2 * np.pi * b * t / n)
        return np.round(x).astype(np.int32)

    def ref(x):
        outv = np.zeros(len(x), np.int32)
        for i, row in enumerate(x):
            byte = 0
            for kk in range(k):
                re = im = np.int64(0)
                for j in range(n):
                    re = np.int64(B.wrap32(re + B.mulw(row[j], cos[kk, j])))
                    im = np.int64(B.wrap32(im + B.mulw(row[j], sin[kk, j])))
                mag2 = B.wrap32(np.int64(B.mulw(re, re))
                                + np.int64(B.mulw(im, im)))
                if mag2 > (1 << 24):
                    byte |= 1 << kk
            outv[i] = byte
        return outv

    return register(Workload(
        key="TT", name="Tree Tracking", sdg="#15 Life on Land",
        algorithm="DFT demodulation", lifetime_s=10 * YEAR_S,
        execs_per_day=24 * 60 * 60 / 5, program=prog, mem_words=256,
        n_inputs=n_in, gen_inputs=gen, ref=ref, out_addr=out,
        max_steps=4_000_000,
        feasible_note="paper: infeasible (analytical model; reduced N=32 "
                      "DFT here, scaled analytically in benchmarks)"))


# ------------------------------------------------------------------ build
WQ = _build_wq()
MC = _build_mc()
FS = _build_fs()
SI = _build_si()
CT = _build_ct()
PT = _build_pt()
AD = _build_ad()
HC = _build_hc()
AP = _build_ap()
GR = _build_gr()
TT = _build_tt()
