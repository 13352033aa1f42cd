"""Declarative render graph over traced passes.

Keeps the reference's render-graph *API shape* (RenderGraph.h:70-219:
named virtual resources, read/write declarations, SaveAsHistory,
Mermaid export) while delegating everything its Compile/Execute did
mechanically — barriers, image layouts, lifetime analysis, pass leveling
(RenderGraph.cpp:102-331) — to XLA: executing the graph simply composes
pure pass functions into one traceable Python callable, and `jax.jit`
performs dependency analysis, fusion, scheduling and memory reuse.

A pass is a function ``fn(reg: dict, ctx) -> dict`` returning its written
resources. Declared reads/writes are validated at build time (the analog
of the reference's validation layers catching missing bindings) and drive
the Mermaid export.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from .params import FrameState


@dataclasses.dataclass
class PassDecl:
    name: str
    fn: Callable
    reads: List[str]
    writes: List[str]
    save_as_history: Dict[str, str]  # virtual resource -> history name
    kind: str = "compute"            # graphics | compute | raytracing


class RenderGraph:
    """Pass stack + resource bookkeeping (RenderGraph.cpp analog)."""

    def __init__(self, width: int, height: int,
                 barrier_passes="multi"):
        self.width, self.height = width, height
        self.passes: List[PassDecl] = []
        self._compiled = False
        # Materialize pass outputs with jax.lax.optimization_barrier.
        # Without it XLA may fuse-duplicate expensive producers
        # (G-buffer gather chains, ray-output relayouts) into every
        # consuming pass and recompute them. This is the one job of the
        # reference's vkCmdPipelineBarrier2 ladder (RenderGraph.cpp:
        # 220-273) that XLA does NOT subsume well.
        # Modes:
        #   "multi" (default) — barrier only resources with >= 2 graph
        #     consumers (or saved as history). Single-consumer outputs
        #     cannot be fuse-DUPLICATED (one consumer), so leaving them
        #     unbarriered lets XLA fuse producer into consumer.
        #   True / "all" — barrier every output (round-1 behavior).
        #   False / "none" — no barriers.
        self.barrier_passes = barrier_passes
        self._multi_consumer: Optional[set] = None

    def reset(self):
        self.passes.clear()
        self._compiled = False

    def add_pass(self, name: str, fn: Callable, reads=(), writes=(),
                 save_as_history: Optional[Dict[str, str]] = None,
                 kind: str = "compute"):
        self.passes.append(PassDecl(
            name=name, fn=fn, reads=list(reads), writes=list(writes),
            save_as_history=dict(save_as_history or {}), kind=kind))
        return self

    # --- compile: validate the DAG (XLA does the real work later) -------
    def compile(self, external: () = ()):  # noqa: B006
        available = set(external)
        history_names = {h for p in self.passes
                         for h in p.save_as_history.values()}
        for p in self.passes:
            for r in p.reads:
                if r.startswith("History_"):
                    # satisfied by FrameState if some pass saves that
                    # history, else by the ReadHistorySafe fallback to the
                    # same-named current-frame resource — one of the two
                    # must exist (RenderGraph.cpp:397-456)
                    hname = r[len("History_"):]
                    if hname not in history_names and hname not in available:
                        raise ValueError(
                            f"pass '{p.name}' reads '{r}' but no pass saves "
                            f"history '{hname}' and no current-frame "
                            f"fallback resource is available")
                    continue
                if r not in available:
                    raise ValueError(
                        f"pass '{p.name}' reads undeclared resource '{r}' "
                        f"(available: {sorted(available)})")
            available.update(p.writes)
            for virt in p.save_as_history:
                if virt not in available:
                    raise ValueError(
                        f"pass '{p.name}' saves '{virt}' as history but "
                        f"never produces it")
        # consumer counts for barrier mode "multi": resources read by
        # >= 2 passes (fan-out — where fuse-duplication can happen), plus
        # everything saved as history (it is materialized regardless, so
        # the barrier only pins that materialization as THE copy)
        reads: Dict[str, int] = {}
        for p in self.passes:
            for r in set(p.reads):
                reads[r] = reads.get(r, 0) + 1
        multi = {r for r, n in reads.items() if n >= 2}
        for p in self.passes:
            multi.update(p.save_as_history.keys())
        self._multi_consumer = multi
        self._compiled = True
        return self

    # --- execute: run passes over a registry dict -----------------------
    def execute(self, registry: dict, ctx, state: FrameState):
        """Returns (registry, new_history dict). ``registry`` seeds
        external resources; history reads pull from ``state`` with
        fallback to the current-frame resource (ReadHistorySafe,
        RenderGraph.cpp:446-456)."""
        if not self._compiled:
            self.compile(external=tuple(registry.keys()))
        new_history: dict = {}
        for p in self.passes:
            for r in p.reads:
                if r.startswith("History_"):
                    hname = r[len("History_"):]
                    if r not in registry:
                        h = state.get(hname)
                        if h is None:
                            h = registry.get(hname)
                        registry[r] = h
            out = p.fn(registry, ctx)
            # write-set validation (the half the reference's tracked
            # ResourceState caught at runtime): a pass must produce
            # exactly what it declared — a misdeclared pass otherwise
            # silently poisons downstream reads
            produced = set(out.keys()) if out else set()
            declared = set(p.writes)
            if produced != declared:
                missing = declared - produced
                extra = produced - declared
                raise ValueError(
                    f"pass '{p.name}' write mismatch: "
                    + (f"declared but not produced {sorted(missing)} "
                       if missing else "")
                    + (f"produced but undeclared {sorted(extra)}"
                       if extra else ""))
            if out:
                mode = self.barrier_passes
                if mode == "multi":
                    keys = [k for k in out
                            if k in (self._multi_consumer or ())]
                elif mode:          # True / "all"
                    keys = list(out.keys())
                else:               # False / "none"
                    keys = []
                if keys:
                    import jax

                    vals = jax.lax.optimization_barrier(
                        tuple(out[k] for k in keys))
                    out = {**out, **dict(zip(keys, vals))}
                registry.update(out)
            for virt, hname in p.save_as_history.items():
                new_history[hname] = registry[virt]
        import os

        if os.environ.get("GRAPH_NO_HISTORY"):
            # perf-attribution knob: drop all history saves (and with
            # them the carried-state materializations) — NOT a rendering
            # mode; temporal passes will see empty history next frame
            new_history = {}
        return registry, new_history

    # --- tooling --------------------------------------------------------
    def export_mermaid(self) -> str:
        """Graph dump (RenderGraph::ExportToMermaid, RenderGraph.cpp:606-741)."""
        lines = ["graph TD"]
        style = {"graphics": ":::graphics", "compute": ":::compute",
                 "raytracing": ":::raytracing"}
        for i, p in enumerate(self.passes):
            lines.append(f"  P{i}[{p.name}]{style.get(p.kind, '')}")
            for r in p.reads:
                rid = r.replace(" ", "_")
                lines.append(f"  R_{rid}([{r}]) --> P{i}")
            for w in p.writes:
                wid = w.replace(" ", "_")
                lines.append(f"  P{i} --> R_{wid}([{w}])")
        lines += [
            "classDef graphics fill:#264653",
            "classDef compute fill:#2a9d8f",
            "classDef raytracing fill:#e76f51",
        ]
        return "\n".join(lines)
