"""FlexiLint — static binary analysis of FlexiBits programs
(DESIGN.md §9.11).

Everything the runtime discovers dynamically about a program — which
opcode classes can retire (`iss.opcode_subset`), how many steps an item
needs (`max_steps` budgets), how many ticks an execution costs (the
§9.10 timing layer) — this module derives *statically* from the encoded
words, as proven properties instead of point measurements:

  * CFG recovery over the instruction words: word-level control-flow
    graph from decoded branch/JAL targets, interprocedural via a
    ra-discipline model of JALR returns, with explicit *degraded mode*
    (everything-reachable over-approximation) for programs the word
    model cannot represent exactly (indirect jumps, misaligned or
    out-of-code transfers, undecodable reachable words).
  * Dataflow diagnostics: definite-assignment (read-before-write =
    error), backward liveness (dead store = warning), unreachable code
    and unreachable-HALT checks.
  * Interval analysis proving load/store addresses against `mem_words`
    where they are affine in constants; the rest is flagged
    runtime-clamped (the steppers' clamp-on-read / drop-on-write
    contract makes every access architecturally defined either way).
  * Reachable opcode subset + static opcode-class mix, a sound input to
    the steppers' subset DCE (`step_branchless(subset=...)`, the packed
    engine's union subset): only reachable words can ever retire live —
    halted lanes keep fetching but every commit is `live`-masked.
  * WCET: per-function longest path with loop SCCs collapsed under
    trip-count bounds (annotated via `Asm.loop_bound` or inferred from
    `addi`-counter branch idioms), generic over a per-word weight — so
    the same machinery yields worst-case *instruction counts* (to
    validate/derive `max_steps`) and worst-case *ticks* under any
    §9.10 cost row (certified energy/carbon in `core/carbon.py`).

Soundness contract (pinned by tests/test_flexilint.py against PyISS):
every dynamically retired pc lies in `reachable`; every retired opcode
class lies in `subset`; every measured tick tally is <= `wcet_ticks`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.flexibits import asm, isa
from repro_torch.flexibits.cycles import (MIX_CLASSES, SHIFT_IDX,
                                          SUBWORD_IDX, TAKEN_IDX)

_MIX_IDX = {c: i for i, c in enumerate(MIX_CLASSES)}
_N_MIX = len(MIX_CLASSES)
_LOAD_NAMES = frozenset(("lb", "lh", "lw", "lbu", "lhu"))
_WIDEN_VISITS = 24          # interval worklist visits before widening
_TOP = None                 # interval lattice top (unknown int32)

ERROR, WARNING, INFO = "error", "warning", "info"


@dataclasses.dataclass(frozen=True)
class Diag:
    severity: str           # error | warning | info
    code: str               # stable diagnostic id, e.g. "dead-store"
    word: Optional[int]     # word index, or None for program-level
    message: str

    def format(self, code_words: Optional[np.ndarray] = None) -> str:
        loc = "program" if self.word is None else f"word {self.word:4d}"
        line = f"{self.severity.upper():7s} {loc}: {self.message}"
        if self.word is not None and code_words is not None:
            line += f"   [{asm.disasm(int(code_words[self.word]))}]"
        return line


def _sx(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _s32(v: int) -> int:
    return _sx(v, 32)


# ---------------------------------------------------------------------------
# decoded-word helpers (operate on asm.Decoded in canonical form)

def _writes_rd(d: asm.Decoded) -> bool:
    return d.name not in isa.S_OPS and d.name not in isa.B_OPS \
        and d.name not in ("ecall", "ebreak")


def _uses(d: asm.Decoded) -> Tuple[int, ...]:
    n = d.name
    if n in isa.R_OPS or n in isa.S_OPS or n in isa.B_OPS:
        return (d.rs1 & 0xF, d.rs2 & 0xF)
    if n in isa.I_OPS or n in isa.SHIFT_OPS:
        return (d.rs1 & 0xF,)
    return ()                       # lui / auipc / jal / ecall / ebreak


def _def_reg(d: asm.Decoded) -> Optional[int]:
    if not _writes_rd(d):
        return None
    rd = d.rd & 0xF
    return rd if rd != 0 else None


def read_registers(analysis: "Analysis") -> FrozenSet[int]:
    """Registers read by at least one CFG-reachable instruction.

    The FlexiLint liveness mask of the FlexiFault measurement layer
    (DESIGN.md §9.14): a register outside this set is provably dead —
    no reachable instruction ever sources it — so a bit flip landing
    there cannot propagate to any architectural output and is not
    counted as corruption. Callers must treat a degraded analysis as
    all-registers-live; this helper only reports what the recovered
    CFG proves.
    """
    regs = set()
    for w in analysis.reachable:
        d = analysis._dec[w]
        if d is not None:
            regs.update(_uses(d))
    return frozenset(regs)


def _worst_ticks(d: asm.Decoded, cost: np.ndarray) -> int:
    """Worst-case ticks one retirement of `d` can cost under a §9.10
    cost row — `iss.classify` + `iss.dynamic_terms` with every dynamic
    term at its maximum (branches taken, register shifts by 31)."""
    two = d.name in isa.TWO_STAGE
    # ebreak has no MIX_CATEGORY entry; it retires as a system op
    mix = isa.MIX_CATEGORY.get(d.name, "system")
    base = int(cost[(_N_MIX if two else 0) + _MIX_IDX[mix]])
    if d.name in isa.B_OPS:
        base += int(cost[TAKEN_IDX])            # assume taken
    if d.name in isa.SHIFT_OPS:
        base += (d.imm & 31) * int(cost[SHIFT_IDX])
    elif d.name in ("sll", "srl", "sra"):
        base += 31 * int(cost[SHIFT_IDX])       # unknown register shamt
    if d.name in ("lb", "lh", "lbu", "lhu", "sb", "sh"):
        base += int(cost[SUBWORD_IDX])
    return base


# ---------------------------------------------------------------------------
# interval domain: (lo, hi) int pairs, or _TOP for unknown

def _ival_const(v: int):
    v = _s32(v)
    return (v, v)


def _ival_join(x, y):
    if x is _TOP or y is _TOP:
        return _TOP
    return (min(x[0], y[0]), max(x[1], y[1]))


def _ival_addc(x, c: int):
    if x is _TOP:
        return _TOP
    lo, hi = x[0] + c, x[1] + c
    if -(1 << 31) <= lo and hi < (1 << 31):
        return (lo, hi)
    return _TOP                                  # int32 wrap hazard


def _ival_add(x, y, sign=1):
    if x is _TOP or y is _TOP:
        return _TOP
    if sign > 0:
        lo, hi = x[0] + y[0], x[1] + y[1]
    else:
        lo, hi = x[0] - y[1], x[1] - y[0]
    if -(1 << 31) <= lo and hi < (1 << 31):
        return (lo, hi)
    return _TOP


class Uninferable(Exception):
    """Raised internally when a loop bound cannot be established."""


@dataclasses.dataclass
class Analysis:
    """Result of FlexiLint over one encoded program."""
    name: str
    code: np.ndarray                     # uint32 words
    mem_words: int
    degraded: Optional[str]              # over-approximation reason
    reachable: FrozenSet[int]            # word indices
    subset: FrozenSet[int]               # opcode classes (iss-compatible)
    reachable_names: FrozenSet[str]      # reachable mnemonics
    mix_sites: Dict[str, int]            # static site count per mix class
    diags: List[Diag]
    functions: Dict[int, FrozenSet[int]]  # entry word -> body words
    loop_headers: Dict[int, int]         # header word -> bound used
    min_steps: Optional[int]             # shortest instr path to HALT
    wcet_steps: Optional[int]            # longest bounded instr path
    # internal CFG state for on-demand wcet_ticks evaluation
    _dec: List[Optional[asm.Decoded]] = dataclasses.field(repr=False,
                                                          default=None)
    _fsucc: Dict[int, Dict[int, Tuple[int, ...]]] = \
        dataclasses.field(repr=False, default=None)
    _forder: List[int] = dataclasses.field(repr=False, default=None)
    _fcalls: Dict[int, Dict[int, int]] = dataclasses.field(repr=False,
                                                           default=None)
    _tick_cache: Dict[bytes, Optional[int]] = \
        dataclasses.field(repr=False, default_factory=dict)

    @property
    def n_words(self) -> int:
        return len(self.code)

    @property
    def errors(self) -> List[Diag]:
        return [d for d in self.diags if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diag]:
        return [d for d in self.diags if d.severity == WARNING]

    # -- WCET under an arbitrary §9.10 cost row ---------------------------
    def wcet_ticks(self, cost) -> Optional[int]:
        """Worst-case total ticks of one execution under `cost`
        (cycles.cost_row), or None when no finite static bound exists
        (degraded CFG / unbounded loop)."""
        cost = np.asarray(cost, np.int64)
        key = cost.tobytes()
        if key not in self._tick_cache:
            # a word pulled into a function body by the cs+1 return
            # summary can be globally unreachable (callee never
            # returns); it never retires, so it prices at 0
            self._tick_cache[key] = self._wcet(
                lambda i: 0 if self._dec[i] is None
                else _worst_ticks(self._dec[i], cost))
        return self._tick_cache[key]

    def max_instr_ticks(self, cost) -> int:
        """Max worst-case ticks any single reachable retirement can
        cost — prices a `max_steps` budget into a tick bound even when
        the structural WCET is unavailable."""
        cost = np.asarray(cost, np.int64)
        if self.degraded is not None or not self.reachable:
            return max(_worst_ticks(asm.decode(isa.encode(n)), cost)
                       if asm.decode(isa.encode(n)) else 0
                       for n in isa.ALL_OPS)
        return max(_worst_ticks(self._dec[i], cost) for i in self.reachable)

    def bound_ticks(self, cost, max_steps: Optional[int] = None) \
            -> Optional[int]:
        """Certified tick bound: min(structural WCET, budget x costliest
        instruction). Budget-only when the CFG is degraded; None when
        neither bound exists."""
        w = self.wcet_ticks(cost)
        if max_steps is not None:
            b = int(max_steps) * self.max_instr_ticks(cost)
            w = b if w is None else min(w, b)
        return w

    # -- generic longest-path WCET ---------------------------------------
    def _wcet(self, weight: Callable[[int], int]) -> Optional[int]:
        if self.degraded is not None or self._forder is None:
            return None
        summaries: Dict[int, Optional[int]] = {}
        for f in self._forder:              # callees before callers
            body = self.functions[f]
            succ = self._fsucc[f]

            def node_weight(i, _f=f):
                w = weight(i)
                callee = self._fcalls[_f].get(i)
                if callee is not None:
                    cw = summaries.get(callee)
                    if cw is None:
                        return None
                    w += cw
                return w

            summaries[f] = _longest(frozenset(body), succ, f, node_weight,
                                    self.loop_headers)
            if summaries[f] is None and f == 0:
                return None
        return summaries.get(0)

    # -- report -----------------------------------------------------------
    def format_report(self, cost=None, measured_ticks: Optional[int] = None) \
            -> str:
        sub = sorted(self.subset)
        out = [f"FlexiLint: {self.name or '<program>'} — "
               f"{self.n_words} words, {len(self.reachable)} reachable, "
               f"{len(self.functions)} function(s), "
               f"opcode subset {len(sub)}/{len(_ALL_OPCODES)} "
               f"[{' '.join(f'{o:#04x}' for o in sub)}]"]
        if self.degraded is not None:
            out.append(f"  DEGRADED: {self.degraded} — "
                       "everything-reachable over-approximation")
        if self.loop_headers:
            bounds = ", ".join(f"w{h}<={b}"
                               for h, b in sorted(self.loop_headers.items()))
            out.append(f"  loop bounds: {bounds}")
        out.append(f"  min-steps-to-halt {self.min_steps}, "
                   f"wcet-steps {self.wcet_steps}")
        if cost is not None:
            line = f"  wcet-ticks {self.wcet_ticks(cost)}"
            if measured_ticks is not None:
                w = self.wcet_ticks(cost)
                ratio = (w / measured_ticks) if (w and measured_ticks) else None
                line += f", measured {measured_ticks}" + \
                    (f" (wcet/measured {ratio:.2f}x)" if ratio else "")
            out.append(line)
        for d in self.diags:
            out.append("  " + d.format(self.code))
        if not self.diags:
            out.append("  clean: no diagnostics")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# longest path with SCC collapse under loop bounds

def _tarjan(nodes: FrozenSet[int], succ) -> List[List[int]]:
    """Iterative Tarjan SCC; returns SCCs in reverse topological order
    (callees of the condensation first)."""
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Dict[int, bool] = {}
    stack: List[int] = []
    sccs: List[List[int]] = []
    counter = [0]
    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in nodes:
                    continue
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(succ.get(w, ()))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs


def _longest(nodes: FrozenSet[int], succ: Dict[int, Tuple[int, ...]],
             entry: int, weight: Callable[[int], Optional[int]],
             bounds: Dict[int, int]) -> Optional[int]:
    """Longest weighted path from `entry` over `nodes`; every nontrivial
    SCC must have a unique header with a bound in `bounds` and collapses
    to bound x (longest single-iteration path). None = no finite bound
    (or a node weight reported None, i.e. an unbounded callee)."""
    if entry not in nodes:
        return 0
    preds: Dict[int, List[int]] = {n: [] for n in nodes}
    for n in nodes:
        for t in succ.get(n, ()):
            if t in nodes:
                preds[t].append(n)
    sccs = _tarjan(nodes, succ)
    scc_id: Dict[int, int] = {}
    for k, scc in enumerate(sccs):
        for n in scc:
            scc_id[n] = k
    scc_weight: List[Optional[int]] = [None] * len(sccs)
    for k, scc in enumerate(sccs):
        members = frozenset(scc)
        trivial = len(scc) == 1 and scc[0] not in succ.get(scc[0], ())
        if trivial:
            scc_weight[k] = weight(scc[0])
            continue
        headers = {n for n in scc
                   if n == entry or any(p not in members for p in preds[n])}
        if len(headers) != 1:
            return None                     # irreducible loop
        h = next(iter(headers))
        bound = bounds.get(h)
        if bound is None:
            return None                     # unbounded loop
        # one iteration: the SCC subgraph with edges back into the
        # header removed (nested SCCs collapse recursively)
        isucc = {n: tuple(t for t in succ.get(n, ())
                          if t in members and t != h) for n in scc}
        inner = _longest(members, isucc, h, weight, bounds)
        if inner is None:
            return None
        scc_weight[k] = bound * inner
    # condensation longest path: sccs is reverse-topological, so walk it
    # backwards (sources first) accumulating max dist-through-node
    dist: List[Optional[int]] = [None] * len(sccs)
    best = None
    for k in range(len(sccs) - 1, -1, -1):
        if scc_id.get(entry) == k:
            dist[k] = 0
        incoming = dist[k]
        if incoming is None:
            continue
        w = scc_weight[k]
        if w is None:
            return None
        here = incoming + w
        best = here if best is None else max(best, here)
        for n in sccs[k]:
            for t in succ.get(n, ()):
                j = scc_id.get(t)
                if j is None or j == k:
                    continue
                if dist[j] is None or dist[j] < here:
                    dist[j] = here
    return best


# ---------------------------------------------------------------------------
# the analyzer

class _Analyzer:
    def __init__(self, code: np.ndarray, mem_words: int,
                 loop_bounds: Dict[int, int], name: str):
        self.code = np.asarray(code).astype(np.uint32, copy=False)
        self.n = len(self.code)
        self.mem_words = int(mem_words)
        self.annotations = dict(loop_bounds or {})
        self.name = name
        self.dec: List[Optional[asm.Decoded]] = \
            [asm.decode(int(w)) for w in self.code]
        self.diags: List[Diag] = []
        self.degraded: Optional[str] = None
        self.calls: set = set()              # word idx of jal ra calls
        self.rets: set = set()               # word idx of ret
        self.succ: Dict[int, Tuple[int, ...]] = {}
        self.reachable: set = set()
        self.in_iv: Dict[int, list] = {}     # word -> 16 intervals (IN)
        self.out_iv: Dict[int, list] = {}
        self.loop_headers: Dict[int, int] = {}

    def diag(self, severity, dcode, word, msg):
        self.diags.append(Diag(severity, dcode, word, msg))

    def degrade(self, reason: str, word: Optional[int]):
        if self.degraded is None:
            self.degraded = reason + ("" if word is None
                                      else f" at word {word}")
            self.diag(WARNING, "degraded", word, f"analysis degraded: "
                      f"{reason} — falling back to everything-reachable")

    # -- successor model (word-level, matches the steppers' fetch) -------
    def _target(self, i: int, imm: int) -> Optional[int]:
        byte = i * 4 + imm
        if imm % 4 != 0:
            self.degrade("misaligned control transfer", i)
            return None
        if byte < 0 or byte >= self.n * 4:
            self.degrade("control transfer outside code", i)
            return None
        return byte // 4

    def _classify_word(self, i: int):
        """-> (successors, kind) where kind in {fall, branch, jump,
        call, ret, halt}; degrades the analysis on anything the exact
        word model cannot represent."""
        d = self.dec[i]
        if d is None:
            self.degrade("undecodable reachable word", i)
            return (), "halt"
        rd = d.rd & 0xF
        if _writes_rd(d) and rd == 1 and d.name != "jal":
            self.degrade("ra written by non-call instruction "
                         f"({d.name})", i)
            return (), "halt"
        if d.name == "jal":
            t = self._target(i, d.imm)
            if t is None:
                return (), "halt"
            if rd == 1:
                self.calls.add(i)
                return (t,), "call"
            return (t,), "jump"
        if d.name == "jalr":
            if rd == 0 and (d.rs1 & 0xF) == 1 and d.imm == 0:
                self.rets.add(i)
                return (), "ret"
            self.degrade("indirect jump (non-return jalr)", i)
            return (), "halt"
        if d.name in isa.B_OPS:
            t = self._target(i, d.imm)
            if t is None:
                return (), "halt"
            if i + 1 >= self.n:
                self.degrade("control reaches end of code", i)
                return (), "halt"
            return (t, i + 1), "branch"
        if d.name in ("ecall", "ebreak"):
            return (), "halt"
        if i + 1 >= self.n:
            self.degrade("control reaches end of code", i)
            return (), "halt"
        return (i + 1,), "fall"

    # -- reachability with incremental ret-edge wiring --------------------
    def _explore(self):
        kind: Dict[int, str] = {}
        work = [0] if self.n else []
        self.reachable = {0} if self.n else set()
        ret_succ: Dict[int, set] = {}
        while work and self.degraded is None:
            i = work.pop()
            succ, k = self._classify_word(i)
            if self.degraded is not None:
                break
            kind[i] = k
            targets = set(succ)
            if k == "call":
                if i + 1 >= self.n:
                    self.degrade("call falls off end of code", i)
                    break
                # returns land after the call site: wire every known ret
                for r in self.rets:
                    ret_succ.setdefault(r, set()).add(i + 1)
                    if i + 1 not in self.reachable:
                        self.reachable.add(i + 1)
                        work.append(i + 1)
            if k == "ret":
                ret_succ[i] = {cs + 1 for cs in self.calls}
                targets |= ret_succ[i]
            self.succ[i] = tuple(sorted(targets))
            for t in targets:
                if t not in self.reachable:
                    self.reachable.add(t)
                    work.append(t)
        if self.degraded is not None:
            self.reachable = set(range(self.n))
            self.succ = {}
            return
        # late-bound ret successors (calls discovered after the ret)
        for r, targets in ret_succ.items():
            self.succ[r] = tuple(sorted(targets))
        self.kind = kind

    # -- dataflow ---------------------------------------------------------
    def _preds(self) -> Dict[int, List[int]]:
        preds: Dict[int, List[int]] = {i: [] for i in self.reachable}
        for i in self.reachable:
            for t in self.succ.get(i, ()):
                preds[t].append(i)
        return preds

    def _local_assign(self, f: int, entry_mask: int,
                      must_def: Dict[int, int]) -> Dict[int, int]:
        """Definite-assignment over one function body (forward must,
        bitmask-16, meet = AND). Calls transfer through the callee's
        must-def summary instead of the shared interprocedural return
        edges — context-sensitive, so registers live across a call are
        not spuriously dropped at other call sites' joins."""
        FULL = (1 << 16) - 1
        succ = self._fsucc[f]
        in_m: Dict[int, int] = {f: entry_mask | 1}
        work = [f]
        while work:
            i = work.pop()
            m = in_m[i]
            callee = self._fcalls[f].get(i)
            if callee is not None:
                out = m | 2 | must_def.get(callee, 0)   # jal wrote ra
            else:
                d = self.dec[i]
                r = _def_reg(d) if d is not None else None
                out = m | (1 << r) if r is not None else m
            for t in succ.get(i, ()):
                nm = out & in_m.get(t, FULL)
                if nm != in_m.get(t):
                    in_m[t] = nm
                    work.append(t)
        return in_m

    def _definite_assignment(self):
        """Context-sensitive forward must-analysis; flags reads of
        registers that are not definitely written on every path (they
        read the zero-initialized register file — legal on the core,
        but a lint error)."""
        FULL = (1 << 16) - 1
        # bottom-up (callees first): regs every return path assigns
        must_def: Dict[int, int] = {}
        for f in self._forder:
            in_m = self._local_assign(f, 0, must_def)
            md = FULL
            for r in self.functions[f]:
                if self.kind.get(r) == "ret":
                    md &= in_m.get(r, FULL)
            must_def[f] = md
        # top-down (callers first): entry state = meet over call sites
        entry_mask: Dict[int, int] = {f: FULL for f in self.functions}
        entry_mask[0] = 1                    # only x0 defined at boot
        reported = set()
        for f in reversed(self._forder):
            in_m = self._local_assign(f, entry_mask.get(f, FULL), must_def)
            for cs, callee in self._fcalls[f].items():
                if callee in entry_mask and cs in in_m:
                    entry_mask[callee] &= in_m[cs] | 2
            for i in sorted(self.functions[f]):
                d = self.dec[i]
                if d is None or i not in self.reachable:
                    continue
                m = in_m.get(i, FULL)
                for r in _uses(d):
                    if r != 0 and not (m & (1 << r)) \
                            and (i, r) not in reported:
                        reported.add((i, r))
                        self.diag(ERROR, "read-before-write", i,
                                  f"{asm.REG_NAMES[r]} may be read before "
                                  "any write (reads the zero-initialized "
                                  "register file)")

    def _liveness(self):
        """Backward may-analysis; flags pure defs whose value no path
        ever reads (dead stores)."""
        preds = self._preds()
        live_out: Dict[int, int] = {i: 0 for i in self.reachable}
        work = list(self.reachable)
        while work:
            i = work.pop()
            d = self.dec[i]
            r = _def_reg(d)
            live_in = live_out[i]
            if r is not None:
                live_in &= ~(1 << r)
            for u in _uses(d):
                live_in |= (1 << u)
            for p in preds.get(i, ()):
                if live_out[p] | live_in != live_out[p]:
                    live_out[p] |= live_in
                    work.append(p)
        for i in sorted(self.reachable):
            d = self.dec[i]
            r = _def_reg(d)
            if r is None or d.name in ("jal", "jalr"):
                continue                     # link writes are control
            if not (live_out[i] & (1 << r)):
                self.diag(WARNING, "dead-store", i,
                          f"result in {asm.REG_NAMES[r]} is never read")

    def _unreachable(self):
        dead = sorted(set(range(self.n)) - self.reachable)
        if dead:
            runs = []
            start = prev = dead[0]
            for i in dead[1:]:
                if i != prev + 1:
                    runs.append((start, prev))
                    start = i
                prev = i
            runs.append((start, prev))
            for a, b in runs:
                self.diag(WARNING, "unreachable-code", a,
                          f"words {a}..{b} are unreachable"
                          if b > a else "word is unreachable")
        if not any(self.dec[i] and self.dec[i].name in ("ecall", "ebreak")
                   for i in self.reachable):
            self.diag(ERROR, "unreachable-halt", None,
                      "no HALT (ecall/ebreak) is reachable — every item "
                      "retires budget-exhausted")

    # -- interval analysis + memory bounds --------------------------------
    def _transfer(self, i: int, iv: list) -> list:
        d = self.dec[i]
        out = list(iv)
        r = _def_reg(d)
        if r is None:
            return out
        n = d.name
        a = iv[d.rs1 & 0xF]
        b = iv[d.rs2 & 0xF]
        v = _TOP
        if n == "lui":
            v = _ival_const(d.imm << 12)
        elif n == "auipc":
            v = _ival_const(i * 4 + _s32(d.imm << 12))
        elif n == "addi":
            v = _ival_addc(a, d.imm)
        elif n == "add":
            v = _ival_add(a, b, 1)
        elif n == "sub":
            v = _ival_add(a, b, -1)
        elif n == "andi":
            if d.imm >= 0:
                v = (0, d.imm) if a is _TOP else \
                    (0, min(d.imm, max(a[1], 0)) if a[0] >= 0 else d.imm)
        elif n in ("slti", "sltiu", "slt", "sltu"):
            v = (0, 1)
        elif n == "slli":
            sh = d.imm & 31
            if a is not _TOP and a[0] >= 0 and (a[1] << sh) < (1 << 31):
                v = (a[0] << sh, a[1] << sh)
        elif n == "srli":
            sh = d.imm & 31
            if a is not _TOP and a[0] >= 0:
                v = (a[0] >> sh, a[1] >> sh)
            elif sh > 0:
                v = (0, ((1 << 32) - 1) >> sh)
        elif n == "srai":
            sh = d.imm & 31
            if a is not _TOP:
                v = (a[0] >> sh, a[1] >> sh)
        elif n in ("jal", "jalr"):
            v = _ival_const(i * 4 + 4)
        elif n in ("xori", "ori") and a is not _TOP and a[0] == a[1]:
            x = a[0]
            v = _ival_const(x ^ d.imm if n == "xori" else x | d.imm)
        # everything else (loads, xor/or/and, reg shifts): TOP
        out[r] = v
        out[0] = (0, 0)
        return out

    def _intervals(self):
        zero = [(0, 0)] * 16                 # the core zero-inits regs
        self.in_iv = {0: zero}
        visits: Dict[int, int] = {}
        work = [0]
        while work:
            i = work.pop(0)
            iv = self.in_iv[i]
            out = self._transfer(i, iv)
            prev = self.out_iv.get(i)
            if prev == out and i in visits:
                continue
            self.out_iv[i] = out
            visits[i] = visits.get(i, 0) + 1
            for t in self.succ.get(i, ()):
                cur = self.in_iv.get(t)
                if cur is None:
                    self.in_iv[t] = list(out)
                    work.append(t)
                    continue
                nxt = [_ival_join(x, y) for x, y in zip(cur, out)]
                if visits.get(t, 0) > _WIDEN_VISITS:
                    nxt = [x if x == y else _TOP
                           for x, y in zip(cur, nxt)]
                if nxt != cur:
                    self.in_iv[t] = nxt
                    work.append(t)

    def _check_bounds(self):
        limit = self.mem_words * 4
        for i in sorted(self.reachable):
            d = self.dec[i]
            if d is None:
                continue
            is_load = d.name in _LOAD_NAMES
            is_store = d.name in isa.S_OPS
            if not (is_load or is_store):
                continue
            base = self.in_iv.get(i, [_TOP] * 16)[d.rs1 & 0xF]
            addr = _ival_addc(base, d.imm)
            if addr is _TOP:
                self.diag(INFO, "runtime-clamped", i,
                          "address not affine in constants — runtime "
                          "clamp-on-read/drop-on-write applies")
            elif addr[1] < 0 or addr[0] >= limit:
                self.diag(ERROR, "oob-access", i,
                          f"address provably outside [0, {limit}) bytes: "
                          f"[{addr[0]}, {addr[1]}]")
            elif addr[0] < 0 or addr[1] >= limit:
                self.diag(WARNING, "partial-oob", i,
                          f"address range [{addr[0]}, {addr[1]}] may "
                          f"leave [0, {limit}) bytes")
            # in-range: proved — no diagnostic

    # -- loop bounds: annotations + counter-idiom inference ---------------
    def _infer_bound(self, header: int, scc: FrozenSet[int],
                     succ: Dict[int, Tuple[int, ...]],
                     preds: Dict[int, List[int]]) -> Optional[int]:
        back = [s for s in scc if header in succ.get(s, ())]
        if len(back) != 1:
            return None
        s = back[0]
        d = self.dec[s]
        if d is None or d.name not in isa.B_OPS:
            return None
        outs = [t for t in succ.get(s, ()) if t not in scc]
        ins = [t for t in succ.get(s, ()) if t == header]
        if len(outs) != 1 or len(ins) != 1:
            return None
        taken_tgt = self._target_quiet(s, d.imm)
        if taken_tgt is None:
            return None
        taken_to_header = (taken_tgt == header)
        for side in (1, 2):
            c = (d.rs1 if side == 1 else d.rs2) & 0xF
            o = (d.rs2 if side == 1 else d.rs1) & 0xF
            if c == 0:
                continue
            bound = self._try_counter(c, o, side, d.name, taken_to_header,
                                      header, s, scc, succ, preds)
            if bound is not None:
                return bound
        return None

    def _target_quiet(self, i: int, imm: int) -> Optional[int]:
        byte = i * 4 + imm
        if imm % 4 != 0 or byte < 0 or byte >= self.n * 4:
            return None
        return byte // 4

    def _try_counter(self, c, o, side, bname, taken_to_header,
                     header, s, scc, succ, preds) -> Optional[int]:
        # exactly one def of c inside the SCC: `addi c, c, k`
        defs = [i for i in scc
                if self.dec[i] is not None and _def_reg(self.dec[i]) == c]
        if len(defs) != 1:
            return None
        dw = defs[0]
        dd = self.dec[dw]
        if dd.name != "addi" or (dd.rs1 & 0xF) != c or dd.imm == 0:
            return None
        k = dd.imm
        # the def must lie on every path header -> back-edge source
        if dw != s and not self._cuts(header, s, dw, scc, succ):
            return None
        # other operand: x0 or interval-constant at the branch
        if o == 0:
            C = 0
        else:
            iv = self.in_iv.get(s, [_TOP] * 16)[o]
            if iv is _TOP or iv[0] != iv[1]:
                return None
            C = iv[0]
        # initial counter value: constant join over external preds
        v0iv = None
        for p in preds.get(header, ()):
            if p in scc:
                continue
            pv = self.out_iv.get(p, [_TOP] * 16)[c]
            v0iv = pv if v0iv is None else _ival_join(v0iv, pv)
        if v0iv is None or v0iv is _TOP or v0iv[0] != v0iv[1]:
            return None
        v0 = v0iv[0]
        if abs(v0) >= (1 << 30) or abs(C) >= (1 << 30) or abs(k) > 2048:
            return None
        # continue-predicate on the counter
        pred_by_cond = {"beq": "eq", "bne": "ne", "blt": "lt", "bge": "ge",
                        "bltu": "ltu", "bgeu": "geu"}[bname]
        if side == 2:                        # counter on rs2: mirror
            pred_by_cond = {"eq": "eq", "ne": "ne", "lt": "gt", "ge": "le",
                            "ltu": "gtu", "geu": "leu"}[pred_by_cond]
        if not taken_to_header:              # loop continues on fall
            pred_by_cond = {"eq": "ne", "ne": "eq", "lt": "ge", "ge": "lt",
                            "le": "gt", "gt": "le", "ltu": "geu",
                            "geu": "ltu", "gtu": "leu",
                            "leu": "gtu"}[pred_by_cond]
        return _counter_trips(pred_by_cond, v0, C, k)

    def _cuts(self, src, dst, via, scc, succ) -> bool:
        """True if every path src->dst inside `scc` passes through
        `via` (reachability check with `via` removed)."""
        if via == src or via == dst:
            return True
        seen = {src}
        work = [src]
        while work:
            v = work.pop()
            for t in succ.get(v, ()):
                if t == via or t not in scc or t in seen:
                    continue
                if t == dst:
                    return False
                seen.add(t)
                work.append(t)
        return True

    def _resolve_loop_bounds(self):
        """Find every loop header in every function body and attach a
        bound: annotation first, counter inference second."""
        for f in self.functions:
            self._resolve_in(frozenset(self.functions[f]),
                             self._fsucc[f], f)

    def _resolve_in(self, nodes, succ, entry):
        preds: Dict[int, List[int]] = {n: [] for n in nodes}
        for n in nodes:
            for t in succ.get(n, ()):
                if t in preds:
                    preds[t].append(n)
        for scc in _tarjan(nodes, succ):
            members = frozenset(scc)
            if len(scc) == 1 and scc[0] not in succ.get(scc[0], ()):
                continue
            headers = {n for n in scc if n == entry
                       or any(p not in members for p in preds[n])}
            if len(headers) != 1:
                self.diag(WARNING, "irreducible-loop", min(scc),
                          "loop with multiple entries — WCET unavailable")
                continue
            h = next(iter(headers))
            if h not in self.loop_headers:
                b = self.annotations.get(h)
                if b is None:
                    b = self._infer_bound(h, members, succ, preds)
                    if b is not None:
                        self.diag(INFO, "inferred-bound", h,
                                  f"counter idiom: header executes "
                                  f"<= {b} times per entry")
                if b is None:
                    self.diag(WARNING, "unbounded-loop", h,
                              "no annotation and no counter idiom — "
                              "WCET unavailable")
                else:
                    self.loop_headers[h] = max(1, int(b))
            # recurse into the loop body for nested loops
            isucc = {n: tuple(t for t in succ.get(n, ())
                              if t in members and t != h) for n in scc}
            self._resolve_in(members, isucc, h)

    # -- function partition ------------------------------------------------
    def _build_functions(self):
        entries = {0} | {self._target_quiet(cs, self.dec[cs].imm)
                         for cs in self.calls}
        entries.discard(None)
        self.functions = {}
        self._fsucc = {}
        self._fcalls = {}
        for f in sorted(entries):
            body = set()
            succ: Dict[int, Tuple[int, ...]] = {}
            calls: Dict[int, int] = {}
            work = [f]
            while work:
                i = work.pop()
                if i in body:
                    continue
                body.add(i)
                k = self.kind.get(i)
                if k == "call":
                    tgt = self._target_quiet(i, self.dec[i].imm)
                    calls[i] = tgt
                    succ[i] = (i + 1,)       # callee summarized
                elif k == "ret":
                    succ[i] = ()
                else:
                    succ[i] = tuple(t for t in self.succ.get(i, ()))
                for t in succ[i]:
                    if t not in body:
                        work.append(t)
            self.functions[f] = frozenset(body)
            self._fsucc[f] = succ
            self._fcalls[f] = calls
        # call-graph topological order, callees first; cycles -> those
        # functions get no WCET (recursion)
        order: List[int] = []
        state: Dict[int, int] = {}
        self._recursive: set = set()

        def visit(f):
            stack = [(f, iter(set(self._fcalls[f].values())))]
            state[f] = 1
            path = [f]
            while stack:
                g, it = stack[-1]
                advanced = False
                for h in it:
                    if h is None or h not in self.functions:
                        continue
                    st = state.get(h, 0)
                    if st == 1:
                        self._recursive.update(path)
                    elif st == 0:
                        state[h] = 1
                        path.append(h)
                        stack.append((h, iter(set(self._fcalls[h].values()))))
                        advanced = True
                        break
                if advanced:
                    continue
                stack.pop()
                state[g] = 2
                path.pop()
                order.append(g)

        for f in self.functions:
            if state.get(f, 0) == 0:
                visit(f)
        self._forder = order
        for f in sorted(self._recursive):
            self.diag(WARNING, "recursion", f,
                      "recursive call cycle — WCET unavailable")

    # -- min-steps-to-halt -------------------------------------------------
    def _min_steps(self) -> Optional[int]:
        from collections import deque
        if not self.n:
            return None
        dist = {0: 1}
        q = deque([0])
        while q:
            i = q.popleft()
            d = self.dec[i]
            if d is not None and d.name in ("ecall", "ebreak"):
                return dist[i]
            for t in self.succ.get(i, ()):
                if t not in dist:
                    dist[t] = dist[i] + 1
                    q.append(t)
        return None

    # -- main --------------------------------------------------------------
    def run(self) -> Analysis:
        if self.n == 0:
            self.diag(ERROR, "unreachable-halt", None, "empty program")
            return Analysis(
                name=self.name, code=self.code, mem_words=self.mem_words,
                degraded="empty program", reachable=frozenset(),
                subset=frozenset(), reachable_names=frozenset(),
                mix_sites={}, diags=self.diags, functions={},
                loop_headers={}, min_steps=None, wcet_steps=None,
                _dec=[], _fsucc=None, _forder=None, _fcalls=None)
        self._explore()
        if self.degraded is not None:
            from repro_torch.flexibits import iss
            subset = iss.opcode_subset(self.code)
            return Analysis(
                name=self.name, code=self.code, mem_words=self.mem_words,
                degraded=self.degraded,
                reachable=frozenset(range(self.n)), subset=subset,
                reachable_names=frozenset(
                    d.name for d in self.dec if d is not None),
                mix_sites={}, diags=self.diags, functions={},
                loop_headers={}, min_steps=None, wcet_steps=None,
                _dec=self.dec, _fsucc=None, _forder=None, _fcalls=None)
        self._build_functions()
        self._definite_assignment()
        self._liveness()
        self._unreachable()
        self._intervals()
        self._check_bounds()
        self._resolve_loop_bounds()
        names = frozenset(self.dec[i].name for i in self.reachable)
        subset = frozenset(
            o for o in _ALL_OPCODES
            if o in {int(self.code[i]) & 0x7F for i in self.reachable})
        mix_sites: Dict[str, int] = {}
        for i in self.reachable:
            cat = isa.MIX_CATEGORY[self.dec[i].name]
            mix_sites[cat] = mix_sites.get(cat, 0) + 1
        res = Analysis(
            name=self.name, code=self.code, mem_words=self.mem_words,
            degraded=None, reachable=frozenset(self.reachable),
            subset=subset, reachable_names=names, mix_sites=mix_sites,
            diags=self.diags, functions=dict(self.functions),
            loop_headers=dict(self.loop_headers),
            min_steps=self._min_steps(), wcet_steps=None,
            _dec=self.dec, _fsucc=self._fsucc, _forder=self._forder,
            _fcalls=self._fcalls)
        res.wcet_steps = res._wcet(lambda i: 1)
        return res


def _counter_trips(pred: str, v0: int, C: int, k: int) -> Optional[int]:
    """Header executions H for a loop `for (r = v0; P(r); r += k)` where
    the continue-test sees r already advanced once. None = not provably
    bounded under predicate `pred`."""
    if pred == "lt":
        if k <= 0:
            return None
        return max(0, (C - 1 - v0) // k) + 1
    if pred == "le":
        if k <= 0:
            return None
        return max(0, (C - v0) // k) + 1
    if pred == "ge":
        if k >= 0:
            return None
        return max(0, (v0 - C) // (-k)) + 1
    if pred == "gt":
        if k >= 0:
            return None
        return max(0, (v0 - (C + 1)) // (-k)) + 1
    if pred == "ne":
        if k == 0 or (C - v0) % k != 0:
            return None
        h = (C - v0) // k
        return h if h >= 1 else None
    if pred == "ltu":
        if v0 < 0 or C < 0:
            return None
        return _counter_trips("lt", v0, C, k)
    if pred == "geu":
        if v0 < 0 or C < 0 or k >= 0 or -k > C:
            return None
        return _counter_trips("ge", v0, C, k)
    return None                              # eq / gtu / leu


# ---------------------------------------------------------------------------
# cached entry points

_ALL_OPCODES = (isa.OP_LUI, isa.OP_AUIPC, isa.OP_JAL, isa.OP_JALR,
                isa.OP_BRANCH, isa.OP_LOAD, isa.OP_STORE, isa.OP_IMM,
                isa.OP_REG, isa.OP_SYSTEM)

_CACHE: Dict[tuple, Analysis] = {}


def analyze_code(code, mem_words: int, *, loop_bounds=None,
                 name: str = "") -> Analysis:
    """Analyze raw encoded words. Results are cached on (code bytes,
    mem_words, bounds) — repeated plan validation/reporting re-uses one
    analysis per program."""
    words = np.asarray(code)
    words = words.view(np.uint32) if words.dtype.itemsize == 4 \
        else words.astype(np.uint32)
    bounds = tuple(sorted((loop_bounds or {}).items()))
    key = (words.tobytes(), int(mem_words), bounds)
    hit = _CACHE.get(key)
    if hit is None:
        hit = _Analyzer(words, mem_words, dict(bounds), name).run()
        if len(_CACHE) > 256:
            _CACHE.clear()
        _CACHE[key] = hit
    return hit


def analyze_program(program: asm.Program, mem_words: int,
                    name: str = "") -> Analysis:
    return analyze_code(program.code, mem_words,
                        loop_bounds=program.loop_bounds, name=name)


def analyze_workload(workload) -> Analysis:
    """Analyze a FlexiBench workload against its own memory footprint."""
    return analyze_program(workload.program, workload.total_mem_words,
                           name=workload.key)
