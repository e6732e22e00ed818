"""Model switching under sleep mode: ``instances`` copies of the model,
made from seeds s, s+1, ..., share one card; one is awake, the others
sleep in pinned host memory (``WeightManager``). Each round the awake
instance sleeps, the next one wakes, and its ``FunctionalServer`` answers
``requests_per_round`` fresh prompts submitted together.

A switch runs from the outgoing ``sleep()`` to the incoming ``wake()``'s
return (which waits for the card), and counts if it ends in the window.
Answered requests are sampled for the logits check as in every cell;
once the window has closed every instance's weights are compared bit for
bit with the same leaves made again from its seed."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchkit import weights
from benchkit.record import Request, Run, Switch, sample
from benchkit.trace import record
from benchkit.traffic import Traffic

from .serve_closed import _server


class Driver:
    def __init__(self, ctx) -> None:
        from repro_torch.core import MMAConfig, make_functional_engine
        from repro_torch.serving import WeightManager

        self.ctx = ctx
        n = int(ctx.mix["instances"])
        self.instance_seeds = [ctx.seed + k for k in range(n)]
        self.traffic = Traffic(ctx.mix, ctx.seed, ctx.cfg.vocab)
        devices = [ctx.device]
        self.engine = make_functional_engine(devices, MMAConfig(**ctx.conf["mma"]))
        self.wms, self.servers = [], []
        for k, s in enumerate(self.instance_seeds):
            params = weights.make(ctx.cfg, s, ctx.init_range, ctx.device, ctx.init)
            self.wms.append(WeightManager(self.engine, params=params))
            self.servers.append(_server(ctx, params))
            del params
            if k:                                  # only instance 0 stays awake
                self.servers[k].params = None
                self.wms[k].sleep()
        self.awake = 0

    def switch(self, to: int, traced: bool) -> Switch:
        a, b = self.awake, to
        self.servers[a].params = None              # the server lets go of its weights
        t0 = time.monotonic()
        with record("bench.sleep", traced):
            self.wms[a].sleep()
        t1 = time.monotonic()
        with record("bench.wake", traced):
            self.wms[b].wake()
        t2 = time.monotonic()
        self.servers[b].params = self.wms[b].params
        self.awake = b
        return Switch(start=t0, slept=t1, end=t2, nbytes=self.wms[b].nbytes)

    def serve(self, run: Run, start: int, traced: bool, capture) -> int:
        """One round's requests on the awake instance; returns how many."""
        srv = self.servers[self.awake]
        k = int(self.ctx.mix["requests_per_round"])
        recs = {}
        for i in range(start, start + k):
            r = self.traffic.request(i)
            rec = Request(index=i, tokens=r["tokens"], issue=time.monotonic(),
                          instance=self.awake)
            req = srv.submit(r["tokens"], max_new_tokens=r["new_tokens"])
            recs[req.req_id] = (rec, req)
        real = srv._prefill

        def prefill(req):
            rec = recs[req.req_id][0]
            capture.current = rec
            rec.prefill_start = time.monotonic()
            with record("bench.prefill", traced):
                real(req)
            rec.first_token = time.monotonic()
            capture.current = None

        srv._prefill = prefill
        try:
            with record("bench.step", traced):
                srv.run_until_done()
        finally:
            del srv._prefill
        srv.scheduler.done.clear()               # the client takes its answers
        for rec, req in recs.values():
            rec.served = req.generated[0] if req.generated else None
            rec.failed = not req.generated
            run.requests.append(rec)
        return k

    def warm_up(self) -> None:
        """One switch each way, and the shortest and longest prompt of the
        mix on each instance."""
        gen = torch.Generator().manual_seed(0)
        for _ in range(len(self.wms)):
            self.switch((self.awake + 1) % len(self.wms), False)
            srv = self.servers[self.awake]
            for n in (self.traffic.shortest_prompt(), self.traffic.longest_prompt()):
                toks = torch.randint(0, self.ctx.cfg.vocab, (n,), generator=gen).numpy()
                srv.submit(toks, max_new_tokens=self.traffic.new_tokens)
            srv.run_until_done()
            srv.scheduler.done.clear()

    def window(self, run: Run, win, traced: bool, capture) -> None:
        win.open()
        run.t0 = time.monotonic()
        run.t1 = run.t0 + run.seconds
        nxt = 0
        while time.monotonic() < run.t1:
            with record("bench.round", traced):
                sw = self.switch((self.awake + 1) % len(self.wms), traced)
                run.switches.append(sw)
                nxt += self.serve(run, nxt, traced, capture)
        win.close()

    def sample(self, run: Run, n: int) -> List[Request]:
        return sample(run.requests, n, self.ctx.seed)

    def checks(self) -> Dict[str, float]:
        """Leaves of any instance that differ in a bit from the same leaves
        made again from its seed: the awake one's on the card, the
        sleeping ones' in pinned host memory."""
        ctx, bad = self.ctx, 0
        for k, (wm, s) in enumerate(zip(self.wms, self.instance_seeds)):
            tree = wm.params if wm.state == "awake" else wm._host_copy
            bad += len(weights.same_bits(tree, ctx.cfg, s, ctx.init_range, ctx.device,
                                         load=lambda t: t.to(ctx.device), init=ctx.init))
        return {"weight_leaves_differ": float(bad)}

    def free(self) -> None:
        self.servers = self.wms = None
        self.engine = None
