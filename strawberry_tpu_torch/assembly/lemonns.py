"""lemon-exact NetworkSimplex for the CMPC flow solve.

The reference solves each locus's min-cost circulation with lemon 1.3's
NetworkSimplex (src/assembly.cpp:897-904, include/lemon/network_simplex.h)
— int32 Value/Cost, BLOCK_SEARCH pivoting, mixed internal arc order, and a
heuristic initial-pivot pass. On loci with DEGENERATE optima (equal-cost
alternative paths — common on realistic many-isoform genes) the particular
optimal flow it lands on is determined by all of those implementation
choices, and the assembled transcript STRUCTURES read the flow directly.
A generic min-cost-flow solver (the previous SSP) finds a different
optimum on ~0.1% of realistic loci, so this module reimplements the
algorithm with the same deterministic behavior, step for step:

  * node/arc internal ids follow lemon ListDigraph iteration order
    (newest-first nodes; per node newest-first out-arcs), then arcs are
    "mixed": skip = max(m/n, 3), position i += skip, wrap to ++j
  * lower bounds shift supplies; EQ (circulation) artificial tree with
    ART_COST = INT32_MAX/2 + 1
  * initialPivots(): per-demand-node min-cost in-arc (strict <, graph
    InArcIt order) — or the single-supply/single-demand reverse DFS
  * BlockSearchPivotRule: block = max(int(sqrt(m)), 10), stateful next
    arc, strict < on reduced cost
  * findLeavingArc tie rules: strict < on the first-node path, <= on the
    second-node path; join by succ_num comparison
  * thread/rev_thread/last_succ/succ_num tree updates and potential
    update exactly as in the reference's vendored header

Everything is integer; Python ints replicate int32 results as long as the
reference itself does not overflow (it does not on these graphs).
Validated flow-for-flow against an instrumented reference binary and by
the golden suites. C++ port: native/lemonns.cc (bit-identical, used on
the hot path); this module is the oracle.
"""
from __future__ import annotations

from math import sqrt
from typing import Dict, List, Optional

INT32_MAX = 2**31 - 1
MAX = INT32_MAX
INF = INT32_MAX  # int has no infinity: INF == MAX (network_simplex.h:653)
ART_COST = INT32_MAX // 2 + 1

STATE_UPPER = -1
STATE_TREE = 0
STATE_LOWER = 1
DIR_DOWN = -1
DIR_UP = 1


def network_simplex(g, cost_map: Dict[int, int],
                    min_flow_map: Dict[int, int]) -> Optional[List[int]]:
    """Run the lemon-equivalent NetworkSimplex on a flow.Graph circulation.

    cost_map / min_flow_map: per graph-arc id (missing = 0), upper = INF.
    Returns per-graph-arc flows, or None when INFEASIBLE/UNBOUNDED."""
    n = g.n_nodes
    m = g.n_arcs()
    if n == 0:
        return None

    # ---- internal ids (ListDigraph iteration order) -----------------------
    # node internal id: NodeIt iterates newest-first
    nid = [0] * n
    for i, node in enumerate(g.nodes_it()):
        nid[node] = i
    # ArcIt order: nodes newest-first, out-arcs newest-first
    arcit: List[int] = []
    for node in g.nodes_it():
        arcit.extend(g.out_arcs(node))
    # arc mixing (network_simplex.h:938-948)
    pos = [0] * m  # graph arc id -> internal id
    if m and n > 1:
        skip = max(m // n, 3)
        i = 0
        j = 0
        for a in arcit:
            pos[a] = i
            i += skip
            if i >= m:
                j += 1
                i = j
    else:
        for i, a in enumerate(arcit):
            pos[a] = i

    root = n
    all_nodes = n + 1
    max_arcs = m + 2 * n
    src = [0] * max_arcs
    dst = [0] * max_arcs
    cost = [0] * max_arcs
    lower = [0] * m
    cap = [0] * max_arcs
    flow = [0] * max_arcs
    state = [0] * max_arcs
    supply = [0] * all_nodes
    pi = [0] * all_nodes
    parent = [0] * all_nodes
    pred = [0] * all_nodes
    pred_dir = [0] * all_nodes
    thread = [0] * all_nodes
    rev_thread = [0] * all_nodes
    succ_num = [0] * all_nodes
    last_succ = [0] * all_nodes

    for a in range(m):
        i = pos[a]
        src[i] = nid[g.arc_src[a]]
        dst[i] = nid[g.arc_dst[a]]
        cost[i] = int(cost_map.get(a, 0))
        lower[i] = int(min_flow_map.get(a, 0))

    # ---- init() (network_simplex.h:1057-...) ------------------------------
    # supplies are all zero pre-shift (circulation)
    for i in range(m):
        c = lower[i]
        cap[i] = INF  # upper == INF == MAX, so "upper < MAX" is false
        supply[src[i]] -= c
        supply[dst[i]] += c
        flow[i] = 0
        state[i] = STATE_LOWER
    sum_supply = 0  # lower shifts cancel

    parent[root] = -1
    pred[root] = -1
    thread[root] = 0
    rev_thread[0] = root
    succ_num[root] = n + 1
    last_succ[root] = root - 1
    supply[root] = 0
    pi[root] = 0

    # EQ supply branch: one artificial arc per node
    search_arc_num = m
    all_arc_num = m + n
    for u in range(n):
        e = m + u
        parent[u] = root
        pred[u] = e
        thread[u] = u + 1
        rev_thread[u + 1] = u
        succ_num[u] = 1
        last_succ[u] = u
        cap[e] = INF
        state[e] = STATE_TREE
        if supply[u] >= 0:
            pred_dir[u] = DIR_UP
            pi[u] = 0
            src[e] = u
            dst[e] = root
            flow[e] = supply[u]
            cost[e] = 0
        else:
            pred_dir[u] = DIR_DOWN
            pi[u] = ART_COST
            src[e] = root
            dst[e] = u
            flow[e] = -supply[u]
            cost[e] = ART_COST

    # pivot state (shared by initial pivots and the main loop)
    st = {"in_arc": -1, "join": -1, "u_in": -1, "v_in": -1, "u_out": -1,
          "delta": 0}

    def find_join():
        u = src[st["in_arc"]]
        v = dst[st["in_arc"]]
        while u != v:
            if succ_num[u] < succ_num[v]:
                u = parent[u]
            else:
                v = parent[v]
        st["join"] = u

    def find_leaving():
        in_arc = st["in_arc"]
        join = st["join"]
        if state[in_arc] == STATE_LOWER:
            first, second = src[in_arc], dst[in_arc]
        else:
            first, second = dst[in_arc], src[in_arc]
        delta = cap[in_arc]
        result = 0
        u_out = -1
        u = first
        while u != join:
            e = pred[u]
            d = flow[e]
            if pred_dir[u] == DIR_DOWN:
                c = cap[e]
                d = INF if c >= MAX else c - d
            if d < delta:
                delta = d
                u_out = u
                result = 1
            u = parent[u]
        u = second
        while u != join:
            e = pred[u]
            d = flow[e]
            if pred_dir[u] == DIR_UP:
                c = cap[e]
                d = INF if c >= MAX else c - d
            if d <= delta:
                delta = d
                u_out = u
                result = 2
            u = parent[u]
        if result == 1:
            st["u_in"], st["v_in"] = first, second
        else:
            st["u_in"], st["v_in"] = second, first
        st["u_out"] = u_out
        st["delta"] = delta
        return result != 0

    def change_flow(change):
        in_arc = st["in_arc"]
        join = st["join"]
        delta = st["delta"]
        if delta > 0:
            val = state[in_arc] * delta
            flow[in_arc] += val
            u = src[in_arc]
            while u != join:
                flow[pred[u]] -= pred_dir[u] * val
                u = parent[u]
            u = dst[in_arc]
            while u != join:
                flow[pred[u]] += pred_dir[u] * val
                u = parent[u]
        if change:
            state[in_arc] = STATE_TREE
            state[pred[st["u_out"]]] = (STATE_LOWER
                                        if flow[pred[st["u_out"]]] == 0
                                        else STATE_UPPER)
        else:
            state[in_arc] = -state[in_arc]

    def update_tree():
        in_arc = st["in_arc"]
        join = st["join"]
        u_in, v_in, u_out = st["u_in"], st["v_in"], st["u_out"]
        old_rev_thread = rev_thread[u_out]
        old_succ_num = succ_num[u_out]
        old_last_succ = last_succ[u_out]
        v_out = parent[u_out]

        if u_in == u_out:
            parent[u_in] = v_in
            pred[u_in] = in_arc
            pred_dir[u_in] = DIR_UP if u_in == src[in_arc] else DIR_DOWN
            if thread[v_in] != u_out:
                after = thread[old_last_succ]
                thread[old_rev_thread] = after
                rev_thread[after] = old_rev_thread
                after = thread[v_in]
                thread[v_in] = u_out
                rev_thread[u_out] = v_in
                thread[old_last_succ] = after
                rev_thread[after] = old_last_succ
        else:
            thread_continue = (thread[old_last_succ]
                               if old_rev_thread == v_in else thread[v_in])
            stem = u_in
            par_stem = v_in
            last = last_succ[u_in]
            after = thread[last]
            thread[v_in] = u_in
            dirty_revs = [v_in]
            while stem != u_out:
                next_stem = parent[stem]
                thread[last] = next_stem
                dirty_revs.append(last)
                before = rev_thread[stem]
                thread[before] = after
                rev_thread[after] = before
                parent[stem] = par_stem
                par_stem = stem
                stem = next_stem
                last = (rev_thread[par_stem]
                        if last_succ[stem] == last_succ[par_stem]
                        else last_succ[stem])
                after = thread[last]
            parent[u_out] = par_stem
            thread[last] = thread_continue
            rev_thread[thread_continue] = last
            last_succ[u_out] = last
            if old_rev_thread != v_in:
                thread[old_rev_thread] = after
                rev_thread[after] = old_rev_thread
            for u in dirty_revs:
                rev_thread[thread[u]] = u
            tmp_sc = 0
            tmp_ls = last_succ[u_out]
            u = u_out
            p = parent[u]
            while u != u_in:
                pred[u] = pred[p]
                pred_dir[u] = -pred_dir[p]
                tmp_sc += succ_num[u] - succ_num[p]
                succ_num[u] = tmp_sc
                last_succ[p] = tmp_ls
                u = p
                p = parent[u]
            pred[u_in] = in_arc
            pred_dir[u_in] = DIR_UP if u_in == src[in_arc] else DIR_DOWN
            succ_num[u_in] = old_succ_num

        up_limit_out = join if last_succ[join] == v_in else -1
        last_succ_out = last_succ[u_out]
        u = v_in
        while u != -1 and last_succ[u] == v_in:
            last_succ[u] = last_succ_out
            u = parent[u]
        if join != old_rev_thread and v_in != old_rev_thread:
            u = v_out
            while u != up_limit_out and last_succ[u] == old_last_succ:
                last_succ[u] = old_rev_thread
                u = parent[u]
        elif last_succ_out != old_last_succ:
            u = v_out
            while u != up_limit_out and last_succ[u] == old_last_succ:
                last_succ[u] = last_succ_out
                u = parent[u]
        u = v_in
        while u != join:
            succ_num[u] += old_succ_num
            u = parent[u]
        u = v_out
        while u != join:
            succ_num[u] -= old_succ_num
            u = parent[u]

    def update_potential():
        u_in, v_in = st["u_in"], st["v_in"]
        sigma = pi[v_in] - pi[u_in] - pred_dir[u_in] * cost[st["in_arc"]]
        end = thread[last_succ[u_in]]
        u = u_in
        while u != end:
            pi[u] += sigma
            u = thread[u]

    # ---- initialPivots() (network_simplex.h:1478-1538) --------------------
    def initial_pivots():
        total = 0
        supply_nodes: List[int] = []  # GRAPH node ids, NodeIt order
        demand_nodes: List[int] = []
        for node in g.nodes_it():
            curr = supply[nid[node]]
            if curr > 0:
                total += curr
                supply_nodes.append(node)
            elif curr < 0:
                demand_nodes.append(node)
        if total <= 0:
            return True
        arc_vector: List[int] = []
        if len(supply_nodes) == 1 and len(demand_nodes) == 1:
            # reverse DFS (stack) from the demand node over in-arcs
            reached = [False] * n
            s, t = supply_nodes[0], demand_nodes[0]
            stack = [t]
            reached[t] = True
            while stack:
                v = stack.pop()
                if v == s:
                    break
                for a in g.in_arcs(v):
                    u = g.arc_src[a]
                    if reached[u]:
                        continue
                    j = pos[a]
                    if cap[j] >= total:
                        arc_vector.append(j)
                        reached[u] = True
                        stack.append(u)
        else:
            for v in demand_nodes:
                min_cost = INT32_MAX
                min_arc = -1
                for a in g.in_arcs(v):
                    c = cost[pos[a]]
                    if c < min_cost:
                        min_cost = c
                        min_arc = a
                if min_arc >= 0:
                    arc_vector.append(pos[min_arc])
        for e in arc_vector:
            st["in_arc"] = e
            if state[e] * (cost[e] + pi[src[e]] - pi[dst[e]]) >= 0:
                continue
            find_join()
            change = find_leaving()
            if st["delta"] >= MAX:
                return False
            change_flow(change)
            if change:
                update_tree()
                update_potential()
        return True

    if not initial_pivots():
        return None  # UNBOUNDED

    # ---- main loop: BlockSearchPivotRule ----------------------------------
    block_size = max(int(sqrt(float(search_arc_num))), 10)
    next_arc = 0

    def find_entering():
        # BlockSearchPivotRule::findEnteringArc (network_simplex.h:377-409):
        # two wrapped scans from _next_arc; a block boundary with a
        # negative minimum jumps straight to search_end (e keeps its value)
        nonlocal next_arc
        minimum = 0
        cnt = block_size
        goto_end = False
        e = next_arc
        while e != search_arc_num:
            c = state[e] * (cost[e] + pi[src[e]] - pi[dst[e]])
            if c < minimum:
                minimum = c
                st["in_arc"] = e
            cnt -= 1
            if cnt == 0:
                if minimum < 0:
                    goto_end = True
                    break
                cnt = block_size
            e += 1
        if not goto_end:
            e = 0
            while e != next_arc:
                c = state[e] * (cost[e] + pi[src[e]] - pi[dst[e]])
                if c < minimum:
                    minimum = c
                    st["in_arc"] = e
                cnt -= 1
                if cnt == 0:
                    if minimum < 0:
                        goto_end = True
                        break
                    cnt = block_size
                e += 1
            if not goto_end and minimum >= 0:
                return False
        next_arc = e
        return True

    while find_entering():
        find_join()
        change = find_leaving()
        if st["delta"] >= MAX:
            return None  # UNBOUNDED
        change_flow(change)
        if change:
            update_tree()
            update_potential()

    # feasibility: artificial arcs must be empty
    for e in range(search_arc_num, all_arc_num):
        if flow[e] != 0:
            return None  # INFEASIBLE

    # transform back (add the lower bounds)
    for i in range(m):
        if lower[i] != 0:
            flow[i] += lower[i]

    return [flow[pos[a]] for a in range(m)]
