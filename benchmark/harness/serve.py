"""The serve driver: the port's ``AgentService`` behind its HTTP server on
``127.0.0.1``, and closed-loop clients posting ``/denoise``.

Set-up builds the agent from the configuration, starts the server on a free
port and warms every shape the mix uses: one request over HTTP, and, with
batching, one direct ``sample_batch`` of each other batch size the
dispatcher can form (its padded sizes), so that nothing is captured in the
window.  The window opens at the first send; each client sends its next
request when the last reply is parsed, until ``--seconds`` have passed; the
window closes at the last reply of the requests sent before then, so every
request counts whole.

The agent's ``sample`` / ``sample_batch`` is wrapped (on the instance;
nothing in the program changes) to keep what the check needs of each call,
its host time and ``info``.  With ``--trace 1``, once the window has closed,
its second agent call is made again on its own arguments under the
profiler: the profiler's own host time, and the reduction of a trace of
some 10^6 kernels (tens of seconds), stay out of the window.

After the window the peak memory is read, the program's state is dropped
and the reference checks a sample of the finished requests drawn from the
seed, the last one always in.
"""
from __future__ import annotations

import gc
import http.client
import json
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from . import port, traffic
from ..metrics.readers import plain_wall_s
from .drivers import Run, device_record
from .trace import profile_call

__all__ = ["run", "PROFILED_CALL", "WARM_CLIENT"]

PROFILED_CALL = 1  # the window's agent call made again under the profiler (the second: the first may be unusual)
WARM_CLIENT = 1000  # the client index of the warm-up's requests: a stream no window client draws from


def _payload(task: str, scene, grasp, Ts: np.ndarray) -> bytes:
    cloud = (lambda p: {"points": p.points.tolist(), "colors": p.colors.tolist()})
    return json.dumps({"task_type": task, "scene": cloud(scene), "grasp": cloud(grasp),
                       "Ts_init": Ts.tolist()}).encode()


def _post(port_no: int, body: bytes) -> Dict[str, Any]:
    conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=600)
    try:
        conn.request("POST", "/denoise", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:500]!r}")
        return json.loads(data)
    finally:
        conn.close()


def _steps_per_request(cfg) -> int:
    return int(sum(sum(s) for s in cfg["diffusion_configs"]["N_steps_list"]))


def _warm(run: Run, agent, port_no: int) -> None:
    params, cfg = run.mix.params, run.spec.config
    scene, grasp, Ts = traffic.request(params, run.seed, WARM_CLIENT, 0)
    _post(port_no, _payload(params["task"], scene, grasp, Ts))
    for R in params.get("warm_batches", [1]):
        if R == 1 or not params.get("batching"):
            continue
        reqs = [traffic.request(params, run.seed, WARM_CLIENT, k) for k in range(1, R + 1)]
        agent.sample_batch([r[0] for r in reqs], [r[1] for r in reqs], np.stack([r[2] for r in reqs]),
                           n_seeds=[len(r[2]) for r in reqs], **cfg["diffusion_configs"])


def _rows(Ts) -> np.ndarray:
    """An agent call's seeds as (requests, seeds, 7) float32."""
    rows = np.asarray(Ts, dtype=np.float32)
    return rows if rows.ndim == 3 else rows[None]


def _wrap(agent, method: str, calls: List[Dict[str, Any]]):
    """Wrap the instance's ``method`` to keep, for each call, what the check
    needs to follow it (the state of numpy's global generator, from which the
    call seeds its noise generator, and its seed rows), its arguments, its
    host time and ``info``.  Returns the method unwrapped."""
    orig = getattr(agent, method)

    def wrapped(*args, **kwargs):
        rec = {"np_state": np.random.get_state(), "rows": _rows(args[2]), "args": (args, kwargs), "profile": None}
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        rec["wall_s"] = time.perf_counter() - t0
        info = out[-1]
        rec.update(extract_s=list(info["extract_s"]), rollout_s=list(info["rollout_s"]), steps=list(info["steps"]))
        calls.append(rec)
        return out

    setattr(agent, method, wrapped)
    return orig


class Session:
    """The system under test for one configuration and mix: the agent, the
    service and its HTTP server, built and warmed once."""

    def __init__(self, run: Run):
        from diffusion_edf_tpu_torch.serve.server import run_server

        self.run = run
        cfg, params = run.spec.config, run.mix.params
        self.task, self.steps = params["task"], _steps_per_request(cfg)
        np.random.seed(run.seed % 2**32)  # the service seeds each request's noise generator from numpy's global state
        self.tmp = tempfile.mkdtemp(prefix="benchmark_")
        self.agent = port.build_agent(cfg, self.tmp, run.root, run.device)
        self.service = port.build_service(cfg, self.agent, params.get("batching"))
        self.httpd = run_server(self.service, "127.0.0.1", 0, block=False)
        self.port_no = self.httpd.server_address[1]
        _warm(run, self.agent, self.port_no)
        if run.device == "cuda":
            torch.cuda.synchronize()
        self.calls: List[Dict[str, Any]] = []  # the agent calls after the warm-up
        self.method = "sample_batch" if params.get("batching") else "sample"
        self.orig = _wrap(self.agent, self.method, self.calls)

    def window(self, seed: int, seconds: float) -> List[Dict[str, Any]]:
        """The closed-loop clients of the mix with the traffic of ``seed``
        for ``seconds``: every request sent, with its reply.  Client ``c``
        sends its first request ``c * start_stagger_s`` after the first
        client: with batching, the first dispatches then hold the same
        requests in every run, and so does every later one (the pattern of
        a closed loop keeps the dispatches it starts with)."""
        params, task, port_no = self.run.mix.params, self.task, self.port_no
        clients = int(params["clients"])
        stagger = float(params.get("start_stagger_s", 0.0))
        firsts = [traffic.request(params, seed, c, 0) for c in range(clients)]
        done: List[Dict[str, Any]] = []
        lock = threading.Lock()
        t0 = time.perf_counter()
        stop_at = t0 + seconds

        def client(c: int) -> None:
            k, req = 0, firsts[c]
            time.sleep(max(0.0, t0 + c * stagger - time.perf_counter()))
            while True:
                body = _payload(task, *req)
                t_send = time.perf_counter()
                if t_send >= stop_at:
                    return
                rec = {"client": c, "k": k, "t_send": t_send, "n_seeds": len(req[2])}
                try:
                    reply = _post(port_no, body)
                    rec["traj"] = np.asarray(reply["trajectories"], dtype=np.float64)
                    rec["energy"] = reply.get("energy")
                    rec["ok"] = True
                except Exception as e:  # noqa: BLE001 - a failed request is counted, and the client goes on
                    rec["ok"], rec["error"] = False, repr(e)
                rec["t_reply"] = time.perf_counter()
                with lock:
                    done.append(rec)
                k += 1
                req = traffic.request(params, seed, c, k)

        threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        done.sort(key=lambda r: r["t_send"])
        return done

    def profile_again(self, index: int) -> Dict[str, Any]:
        """The agent call ``index`` of the window (the last, if there were
        fewer) made again on its own arguments, under the profiler, out of
        the window: the same entries, with the service idle."""
        c = self.calls[min(index, len(self.calls) - 1)]
        args, kwargs = c["args"]
        out, prof = profile_call(lambda: self.orig(*args, **kwargs))
        rec = {"rows": c["rows"], "steps": list(out[-1]["steps"]), "profile": prof}
        if self.method == "sample":
            rec["requests"], rec["traj"] = [(args[0], args[1])], np.asarray(out[0])[None]
        else:
            rec["requests"], rec["traj"] = list(zip(args[0], args[1])), np.asarray(out[0])
        return rec

    def close(self) -> None:
        """Stop the server and let the program's state go."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.agents = {}  # the dispatcher thread keeps the service: let the agents go
        self.agent = self.service = self.orig = None
        gc.collect()
        if self.run.device == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run(run: Run) -> Dict[str, Any]:
    params = run.mix.params
    session = Session(run)
    record: Dict[str, Any] = {"task": session.task, "steps_per_request": session.steps, "calls": session.calls}
    try:
        agent, service = session.agent, session.service
        entries0, batch0 = port.runtime_entries(agent), dict(service.batch_stats)
        record["setup_s"] = time.perf_counter() - run.t_start
        done = session.window(run.seed, run.seconds)
        record["window_s"] = max(r["t_reply"] for r in done) - min(r["t_send"] for r in done) if done else 0.0
        record["entries"] = (entries0, port.runtime_entries(agent))
        record["batch"] = (batch0, dict(service.batch_stats))
        record["device"] = device_record(run.device)
        if run.trace and session.calls:
            record["calls"] = session.calls + [session.profile_again(PROFILED_CALL)]
        del agent, service
    finally:
        session.close()
    record["requests"] = [{k: v for k, v in r.items() if k not in ("traj", "energy")} for r in done]
    record["attempted"] = len(done)
    record["failed"] = sum(1 for r in done if not r["ok"])
    _describe_window(done, session.calls)
    from ..reference.serve_check import ReferenceModels

    refs = ReferenceModels(run.spec.config, run.root, run.device)
    record["readings"] = readings(run, done, run.seed, session.calls, refs=refs)
    limits = params["check"]["limits"]
    record["checks"] = {k: {"value": record["readings"].get(k, float("inf")), "limit": limits[k]} for k in limits}
    prof = next((c for c in record["calls"] if c["profile"] is not None), None)
    if prof is not None:
        from ..reference.work_count import call_work

        prof["profile"] = prof["profile"]()
        prof["work"] = call_work(refs, prof["requests"], np.asarray(prof["traj"], dtype=np.float32))
        p = prof["profile"]
        record["device"].update(busy_s=p["busy_s"], window_s=p["window_s"])
        print(f"trace: busy_s {p['busy_s']!r}, window_s (first kernel to last) {p['window_s']!r}, profiled wall_s "
              f"{p['wall_s']!r}, unprofiled wall_s of its shape {plain_wall_s(record)!r}", file=sys.stderr)
        record["breakdown"] = {"device_ops": p.get("device_ops", []), "idle_gaps": p.get("idle_gaps", [])}
    return record


def _describe_window(done: List[Dict[str, Any]], calls: List[Dict[str, Any]]) -> None:
    """The window's requests and agent calls on standard error: latencies,
    host times and batch sizes, each in the order they came."""
    lat = [round(1e3 * (r["t_reply"] - r["t_send"]), 1) for r in done if r["ok"]]
    print(f"window: {len(done)} requests, latency ms {lat}; {len(calls)} agent calls, host ms "
          f"{[round(1e3 * c['wall_s'], 1) for c in calls]}, requests a call {[c['rows'].shape[0] for c in calls]}",
          file=sys.stderr)


def check_sample(run: Run, done: List[Dict[str, Any]], seed: int) -> List[Dict[str, Any]]:
    """The finished requests the reference checks: ``check.requests`` of
    them drawn from ``seed``, the last one always in."""
    ok = [r for r in done if r["ok"]]
    if not ok:
        return []
    rng = np.random.default_rng(np.random.SeedSequence(traffic.seed_words(seed, 4)))
    n = min(int(run.mix.params["check"]["requests"]), len(ok))
    pick = {len(ok) - 1} | (set(rng.choice(len(ok) - 1, size=n - 1, replace=False).tolist()) if n > 1 else set())
    return [ok[i] for i in sorted(pick)]


def call_of(calls: List[Dict[str, Any]], Ts: np.ndarray):
    """(the agent call that served the request whose seeds are ``Ts``, its
    row in the call's batch)."""
    Ts = np.asarray(Ts, dtype=np.float32)
    for c in calls:
        for i, rows in enumerate(c["rows"]):
            if rows.shape == Ts.shape and np.array_equal(rows, Ts):
                return c, i
    raise LookupError("no agent call served this request")


def noise_seed(call: Dict[str, Any]) -> int:
    """The seed of the noise generator that the agent drew for ``call``:
    the first draw of numpy's global generator in the call's state."""
    rs = np.random.RandomState()
    rs.set_state(call["np_state"])
    return int(rs.randint(0, 2**31 - 1))


def readings(run: Run, done: List[Dict[str, Any]], seed: int, calls: List[Dict[str, Any]], control: bool = False,
             refs=None) -> Dict[str, float]:
    """The largest of each number the reference reads over the checked
    requests (``control``: TF32 in the program's place)."""
    from ..reference.serve_check import ReferenceModels, check_request

    params = run.mix.params
    sample = check_sample(run, done, seed)
    if not sample:
        return {}
    refs = refs or ReferenceModels(run.spec.config, run.root, run.device)
    rng = np.random.default_rng(np.random.SeedSequence(traffic.seed_words(seed, 5)))
    worst: Dict[str, float] = {}
    for r in sample:
        scene, grasp, Ts = traffic.request(params, seed, r["client"], r["k"])
        call, row = call_of(calls, Ts)
        got = check_request(refs, scene, grasp, Ts, r["traj"], r["energy"], int(params["check"]["steps"]), rng,
                            noise=(noise_seed(call), row, *call["rows"].shape[:2]), control=control)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
