"""Closed-loop clients of one ``FunctionalServer``: each client issues its
next request the moment the harness sees its last one answered (no think
time). The mix's ``clients`` set the load and its ``server`` block the
server's ``max_running``, ``device_budget_tokens`` and ``page_size``.

Requests are the mix's sequence in order, whatever the timing. Once the
window closes no client issues again, and those in flight are drained
(their TTFT counts; their tokens fall outside the window's rate).

The server keeps every finished request, with its KV caches, in
``scheduler.done``; the clients take their answers out of it after each
step, or a long window would fill the card with dead caches."""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchkit import weights
from benchkit.record import Request, Run, sample
from benchkit.trace import record
from benchkit.traffic import Traffic


def _server(ctx, params):
    from repro_torch.serving import FunctionalServer

    s = ctx.mix["server"]
    return FunctionalServer(ctx.cfg, params=params, max_running=int(s["max_running"]),
                            device_budget_tokens=int(s["device_budget_tokens"]),
                            page_size=int(s["page_size"]), max_len=ctx.max_len,
                            device=ctx.device)


def _timed(srv, run: Run, live: Dict[int, Request], traced: bool, capture) -> None:
    """Stamp each request's prefill start and first token on the harness's
    clock, around the server's own ``_prefill`` (which returns once the
    first token is on the host)."""
    real = srv._prefill

    def prefill(req):
        rec = live.get(req.req_id)
        capture.current = rec
        if rec is not None:
            rec.prefill_start = time.monotonic()
        with record("bench.prefill", traced):
            real(req)
        if rec is not None:
            rec.first_token = time.monotonic()
        capture.current = None

    srv._prefill = prefill


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.traffic = Traffic(ctx.mix, ctx.seed, ctx.cfg.vocab)
        self.params = weights.make(ctx.cfg, ctx.seed, ctx.init_range, ctx.device, ctx.init)
        self.instance_seeds = [ctx.seed]

    def warm_up(self) -> None:
        """Serve the shortest and the longest prompt the mix can send, on a
        server of their own, so the measured server starts empty."""
        ctx = self.ctx
        srv = _server(ctx, self.params)
        gen = torch.Generator().manual_seed(0)
        for n in (self.traffic.shortest_prompt(), self.traffic.longest_prompt()):
            toks = torch.randint(0, ctx.cfg.vocab, (n,), generator=gen).numpy()
            srv.submit(toks, max_new_tokens=self.traffic.new_tokens)
        srv.run_until_done()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        self.server = _server(ctx, self.params)

    def window(self, run: Run, win, traced: bool, capture) -> None:
        srv, clients = self.server, int(self.ctx.mix["clients"])
        live: Dict[int, Request] = {}
        issued = [0]
        _timed(srv, run, live, traced, capture)

        def issue():
            r = self.traffic.request(issued[0])
            rec = Request(index=issued[0], tokens=r["tokens"], issue=time.monotonic())
            issued[0] += 1
            try:
                req = srv.submit(r["tokens"], max_new_tokens=r["new_tokens"])
            except ValueError:
                rec.failed = True
                run.requests.append(rec)
                return
            rec.req = req
            live[req.req_id] = rec
            run.requests.append(rec)

        win.open()
        run.t0 = time.monotonic()
        run.t1 = run.t0 + run.seconds
        open_ = True
        for _ in range(clients):
            issue()
        while live:
            with record("bench.step", traced):
                srv.step()
            srv.scheduler.done.clear()           # the client takes its answers
            if open_ and time.monotonic() >= run.t1:
                open_ = False
                win.close()
            for rid, rec in list(live.items()):
                req = rec.req
                if req.state in ("done", "rejected"):
                    del live[rid]
                    rec.failed = req.state == "rejected" or not req.generated
                    rec.served = req.generated[0] if req.generated else None
                    rec.hit_tokens = int(req.hit_tokens)
                    del rec.req
                    if open_:
                        issue()
        if open_:
            win.close()

    def sample(self, run: Run, n: int) -> List[Request]:
        return sample(run.requests, n, self.ctx.seed)

    def checks(self) -> Dict[str, float]:
        return {}

    def free(self) -> None:
        self.server = None
        self.params = None
