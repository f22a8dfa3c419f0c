"""The flow-solve crossover on the GPU: the port's counterpart of the JAX
package's tools/bench_mcf_crossover.py, on the same problem generator.

    python -m strawberry_tpu_torch.tools.mcf_crossover [--device cpu]
        [--nodes 3,4,...] [--batches 89,101] [--reps 3] [--out]

For each node count (default: 2-15, the main path's range, then 16, 32,
33, 64, 128, 129 and 256: either side of the kernel's warp / CTA split at
32 and of 128) it makes the largest batch of splice-graph-shaped problems
and times, per problem:
  - host, solve_dense: mincostflow.solve_dense (native mcf.cc) in a loop,
    on copies, as batched_mcf runs a host-routed problem;
  - host, network_simplex: the lemon-exact solver the pipeline's default
    runs (assembly/lemonns.py) on the same problems as flow graphs (one
    pass; graph building not timed);
  - device: assembly/device.batched_mcf with device_min_nodes=0 (packing,
    one copy each way, the kernel, unpacking), at each batch size of
    --batches (default 89, the main path's mean problems a call at 1M
    fragments, and 101, its largest call), best and median of --reps
    after one untimed call.
Every device flow must equal solve_dense's (an infeasible problem must be
flagged by both); mismatches are counted. network_simplex may break ties
otherwise, so its agreement is only reported.

The rule routing.py applies: device_min_nodes is the smallest measured
node count from which on the device beats solve_dense per problem at
every batch size and every larger node count. It acts only inside the
opt-in STRAWB_DEVICE_MCF=1 route.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from . import common

NODES = tuple(range(2, 16)) + (16, 32, 33, 64, 128, 129, 256)


def make_problem(rng, M: int, n_paths: int):
    """Feasible dense-MCF instance shaped like a constrained path cover:
    nodes sorted genomically, source=0 / sink=M-1, forward arcs only,
    lower bound 1 on some covering-path arcs (the reference's constraint
    arcs, src/assembly.cpp:735-763), cost = max_weight - support. The JAX
    package's tools/bench_mcf_crossover.py generator."""
    cost = np.zeros((M, M), np.int64)
    has = np.zeros((M, M), bool)
    lower = np.zeros((M, M), np.int64)
    support = np.zeros((M, M), np.int64)
    for _ in range(n_paths):
        k = rng.integers(2, max(3, M // 2))
        inner = rng.choice(np.arange(1, M - 1), size=min(k, M - 2),
                           replace=False)
        path = np.concatenate([[0], np.sort(inner), [M - 1]])
        for u, v in zip(path[:-1], path[1:]):
            has[u, v] = True
            support[u, v] += rng.integers(1, 50)
    # adjacency arcs between consecutive segments (weak support)
    for u in range(1, M - 2):
        has[u, u + 1] = True
        support[u, u + 1] += 1
    maxw = support.max() + 1
    cost[has] = maxw - support[has]
    # constraint arcs: lower bound 1 on the best-supported interior arcs
    interior = has.copy()
    interior[0, :] = False
    interior[:, M - 1] = False
    cand = np.argwhere(interior)
    if len(cand):
        take = cand[rng.permutation(len(cand))[:max(1, len(cand) // 4)]]
        lower[take[:, 0], take[:, 1]] = 1
    # circulation arc sink->source keeps the cover feasible
    has[M - 1, 0] = True
    cost[M - 1, 0] = 0
    return cost, has, lower


def as_graph(cost, has, lower):
    """The dense problem as a flow.Graph with its cost and lower-bound
    maps (arcs in row-major order), for network_simplex."""
    from ..assembly.flow import Graph
    g = Graph()
    for _ in range(cost.shape[0]):
        g.add_node()
    cm, lm = {}, {}
    for u, v in zip(*np.nonzero(has)):
        a = g.add_arc(int(u), int(v))
        cm[a], lm[a] = int(cost[u, v]), int(lower[u, v])
    return g, cm, lm


def graph_flow(g, flows, M):
    m = np.zeros((M, M), np.int64)
    for a, x in enumerate(flows):
        m[g.arc_src[a], g.arc_dst[a]] += x
    return m


def same(a, b):
    if a is None or b is None:
        return (a is None) == (b is None)
    return np.array_equal(a, b)


def main(argv=None):
    p = common.parser(__doc__.split("\n")[0])
    p.add_argument("--nodes", default=",".join(map(str, NODES)))
    p.add_argument("--batches", default="89,101")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    common.setup(args)
    from ..assembly.device import batched_mcf
    from ..assembly.lemonns import network_simplex
    from ..assembly.mincostflow import solve_dense

    nodes = [int(x) for x in args.nodes.split(",")]
    batches = sorted(int(x) for x in args.batches.split(","))
    rng = np.random.default_rng(7)   # the JAX tool's seed
    solve_dense(*make_problem(np.random.default_rng(0), 4, 3))  # load lib
    rows, mismatches = [], 0
    for M in nodes:
        probs = [make_problem(rng, M, n_paths=max(3, M // 8))
                 for _ in range(batches[-1])]
        t0 = time.perf_counter()
        host = [solve_dense(c.copy(), h.copy(), l.copy())
                for c, h, l in probs]
        host_us = (time.perf_counter() - t0) / len(probs) * 1e6
        graphs = [as_graph(*x) for x in probs]
        t0 = time.perf_counter()
        ns = [network_simplex(*x) for x in graphs]
        ns_us = (time.perf_counter() - t0) / len(probs) * 1e6
        ns_equal = sum(same(h, None if f is None else
                            graph_flow(g[0], f, M))
                       for h, f, g in zip(host, ns, graphs))
        row = {"nodes": M, "infeasible": sum(h is None for h in host),
               "host_solve_dense_us": host_us,
               "host_network_simplex_us": ns_us,
               "network_simplex_equal": ns_equal, "device": {}}
        for B in batches:
            sub = probs[:B]
            stats = {}
            flows = batched_mcf(sub, device_min_nodes=0, stats=stats)
            bad = sum(not same(h, f) for h, f in zip(host, flows))
            if stats.get("device", 0) != len(sub):
                raise RuntimeError(f"{M} nodes: {stats} of {B} on the "
                                   "device")
            mismatches += bad
            t = common.timed(lambda: batched_mcf(sub, device_min_nodes=0),
                             args.reps)
            row["device"][str(B)] = {
                "best_us": t["best_s"] / B * 1e6,
                "median_us": t["median_s"] / B * 1e6,
                "mismatches": bad,
                "classes": {k: v for k, v in stats.items()
                            if k.startswith("device_")}}
        rows.append(row)

    def wins(r):
        return all(d["median_us"] < r["host_solve_dense_us"]
                   for d in r["device"].values())
    min_nodes = None
    for r in reversed(rows):
        if not wins(r):
            break
        min_nodes = r["nodes"]
    common.emit("mcf_crossover", args, {
        "device": args.device, "batches": batches, "rows": rows,
        "mismatches": mismatches,
        # None: the device lost at the largest node count measured
        "device_min_nodes_rule": min_nodes,
        "note": "per-problem microseconds on the host's clock; device = "
                "batched_mcf(device_min_nodes=0) a call over the batch, "
                "the device synchronized by its copy back"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
