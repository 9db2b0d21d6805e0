"""Inference serving host: JSON-over-HTTP agent service (counterpart of the
JAX package's ``serve/server.py``, with the same endpoints and payloads).

  POST /denoise               - full denoising trajectories per seed pose
  POST /request_trajectories  - final poses -> pre-pick/pre-place approach
                                trajectories
  POST /reconfigure           - runtime-mutable diffusion/trajectory configs
  GET  /get_configs           - current configs
  GET  /health

Payloads are JSON: point clouds as {"points": [[x,y,z],...], "colors": ...},
poses as [[qw,qx,qy,qz,x,y,z], ...].  Units on the wire are metres (the
agent rescales to model units and back).  Errors come back as JSON 500s.

Threads: ``ThreadingHTTPServer`` runs every request on its own thread, but
the device work of a service runs on one thread at a time.  The models keep
unguarded state (the folded weights and tensor-core operands cached on each
attention, the device tables of ``nn/edge_kernel.py``, the kernels' launch
counters), so with batching on, only the dispatcher thread calls the agents;
without it, one lock serialises every agent call.

Spans (``utils/profiling.py``): each ``POST /denoise`` is a
``serve.request`` span with a request id that the service numbers, and its
``serve.decode``, ``serve.queue`` and ``serve.encode`` children; each agent
call is a ``serve.dispatch`` span with its request ids and its real and
padding requests, above the agent's own spans.  ``batch_stats`` counts the
real (``batched_requests``) and padding (``padded_requests``) requests of
the batched dispatches.  To see where a served request's time goes, call
``profiling.record(True)`` in the server's process, send traffic, and read
``profiling.drain()``; the spans of host work are host ranges in any
``profiling.trace`` file.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from ..agent import DiffusionEdfAgent
from ..train.data import PointCloud
from ..utils.profiling import span
from .trajectories import compute_pre_pick_trajectory, compute_pre_place_trajectory

__all__ = ["AgentService", "run_server"]


class _PendingRequest:
    """One enqueued /denoise awaiting the batching dispatcher."""

    __slots__ = ("task", "scene", "grasp", "Ts_init", "request", "queue", "event", "result", "error")

    def __init__(self, task, scene, grasp, Ts_init, request: int, queue: span):
        self.task = task
        self.scene = scene
        self.grasp = grasp
        self.Ts_init = Ts_init
        self.request = request  # its id
        self.queue = queue  # its serve.queue span, started
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None


class AgentService:
    """Task-routed agent pair + runtime-mutable configs.

    With ``batching`` set (``{"max_batch": 4, "window_ms": 20}``), a
    dispatcher thread gathers concurrent same-task ``/denoise`` requests into
    one ``DiffusionEdfAgent.sample_batch`` call (one score evaluation per
    Langevin step for all of them).  Batch sizes are padded up to a power of
    two (with copies of the first request), as in the JAX service;
    ``batch_stats`` counts the dispatches, the requests, and the real
    (``batched_requests``) and padding (``padded_requests``) requests of
    the dispatches."""

    def __init__(
        self,
        pick_agent: Optional[DiffusionEdfAgent],
        place_agent: Optional[DiffusionEdfAgent],
        configs: Dict[str, Any],
        batching: Optional[Dict[str, Any]] = None,
    ):
        self.agents = {"pick": pick_agent, "place": place_agent}
        self.configs = configs
        # RLock: reconfigure() calls get_configs() while holding the lock
        self._lock = threading.RLock()
        self._device_lock = threading.Lock()  # every agent call without batching
        self.batching = dict(batching) if batching else None
        self.batch_stats = {"dispatches": 0, "requests": 0, "batched_requests": 0, "padded_requests": 0}
        self._request_ids = itertools.count(1)
        if self.batching:
            self._queue: List[_PendingRequest] = []
            self._qcv = threading.Condition()
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    def get_configs(self) -> Dict[str, Any]:
        with self._lock:
            return json.loads(json.dumps(self.configs))

    def reconfigure(self, updates: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self.configs.update(updates)
            return self.get_configs()

    # ------------------------------------------------------------------ #
    def request_id(self) -> int:
        """A new request id (the ``request`` of a request's spans)."""
        return next(self._request_ids)

    def denoise(self, req: Dict[str, Any], request: Optional[int] = None) -> Dict[str, Any]:
        """One /denoise request; ``request`` is its id (a new one if None)."""
        request = self.request_id() if request is None else request
        task = req["task_type"]
        agent = self.agents[task]
        assert agent is not None, f"no agent for task {task}"
        with span("serve.decode", request=request):
            scene = PointCloud(points=np.asarray(req["scene"]["points"]), colors=np.asarray(req["scene"]["colors"]))
            grasp = PointCloud(points=np.asarray(req["grasp"]["points"]), colors=np.asarray(req["grasp"]["colors"]))
            Ts_init = np.asarray(req["Ts_init"], dtype=np.float32)
        with self._lock:
            self.batch_stats["requests"] += 1
        queue = span("serve.queue", request=request).start()
        if self.batching:
            pending = _PendingRequest(task, scene, grasp, Ts_init, request, queue)
            with self._qcv:
                self._queue.append(pending)
                self._qcv.notify()
            pending.event.wait()
            if pending.error is not None:
                raise pending.error
            return pending.result
        cfg = self._diff_cfg(task)
        with self._device_lock:
            queue.end()
            with span("serve.dispatch", request=(request,), device_work=True, real=1, padded=0):
                traj, _, _, info = agent.sample(scene, grasp, Ts_init, **cfg)
        with span("serve.encode", request=request):
            out = {"trajectories": agent.unprocess_poses(traj).tolist()}  # back to metres
            if "energy" in info:
                out["energy"] = np.asarray(info["energy"]).tolist()
        return out

    def _diff_cfg(self, task: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self.configs[f"{task}_diffusion_configs"])

    # ---- batching dispatcher ----------------------------------------- #
    def _dispatch_loop(self):
        max_batch = int(self.batching.get("max_batch", 4))
        window_s = float(self.batching.get("window_ms", 20)) / 1e3
        while True:
            with self._qcv:
                while not self._queue:
                    self._qcv.wait()
                first = self._queue.pop(0)
            # collect more same-task requests within the window
            batch = [first]
            deadline = time.monotonic() + window_s
            while len(batch) < max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                with self._qcv:
                    if not self._queue:
                        self._qcv.wait(timeout=remaining)
                    take = [p for p in self._queue if p.task == first.task]
                    for p in take[: max_batch - len(batch)]:
                        self._queue.remove(p)
                        batch.append(p)
            self._run_batch(batch)

    def _run_batch(self, batch: List[_PendingRequest]):
        task = batch[0].task
        agent = self.agents[task]
        for p in batch:
            p.queue.end()
        try:
            cfg = self._diff_cfg(task)
            # pad seed counts to the batch max (copies of a request's last
            # seed; sample_batch ranks them after its real seeds), batch size
            # to a power of two
            nT = max(p.Ts_init.shape[0] for p in batch)
            R = 1 << (len(batch) - 1).bit_length()
            Ts = np.stack(
                [np.concatenate([p.Ts_init, np.repeat(p.Ts_init[-1:], nT - p.Ts_init.shape[0], 0)]) for p in batch]
                + [np.broadcast_to(batch[0].Ts_init[-1], (nT, 7))] * (R - len(batch))
            )
            scenes = [p.scene for p in batch] + [batch[0].scene] * (R - len(batch))
            grasps = [p.grasp for p in batch] + [batch[0].grasp] * (R - len(batch))
            n_seeds = [p.Ts_init.shape[0] for p in batch] + [nT] * (R - len(batch))
            with span("serve.dispatch", request=tuple(p.request for p in batch), device_work=True,
                      real=len(batch), padded=R - len(batch)):
                traj_b, info = agent.sample_batch(scenes, grasps, Ts, n_seeds=n_seeds, **cfg)
            with self._lock:
                self.batch_stats["dispatches"] += 1
                self.batch_stats["batched_requests"] += len(batch)
                self.batch_stats["padded_requests"] += R - len(batch)
            for i, p in enumerate(batch):
                n_i = p.Ts_init.shape[0]
                with span("serve.encode", parent=p.queue.parent, request=p.request):
                    out = {"trajectories": agent.unprocess_poses(traj_b[i][:, :n_i]).tolist()}  # metres
                    if "energy" in info:
                        # energy-sorted per request; the padding seeds sort last
                        out["energy"] = np.asarray(info["energy"])[i][:n_i].tolist()
                p.result = out
                p.event.set()
        except BaseException as e:  # noqa: BLE001
            for p in batch:
                p.error = e
                p.event.set()

    def request_trajectories(self, req: Dict[str, Any]) -> Dict[str, Any]:
        task = req["task_type"]
        den = self.denoise(req)
        final_poses = np.asarray(den["trajectories"])[-1]  # (nT, 7), metres
        with self._lock:
            tcfg = dict(self.configs.get(f"{task}_trajectory_configs", {}))
        trajs = []
        for pose in final_poses:
            if task == "pick":
                trajs.append(compute_pre_pick_trajectory(
                    pose, approach_len=float(tcfg.get("approach_len", 0.1)), n_steps=int(tcfg.get("n_steps", 10)),
                ).tolist())
            else:
                trajs.append(compute_pre_place_trajectory(
                    pose,
                    scene_points=np.asarray(req["scene"]["points"]),
                    grasp_points=np.asarray(req["grasp"]["points"]),
                    n_steps=int(tcfg.get("n_steps", 20)),
                    dt=float(tcfg.get("dt", 1e-4)),
                    cutoff_r=float(tcfg.get("cutoff_r", 0.05)),
                    eps=float(tcfg.get("eps", 1e-4)),
                    max_num_neighbors=int(tcfg.get("max_num_neighbors", 100)),
                ).tolist())
        return {"trajectories": trajs, "denoise": den}


def _make_handler(service: AgentService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/get_configs":
                self._send(200, service.get_configs())
            elif self.path == "/health":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "unknown endpoint"})

        def _read(self) -> Dict:
            return json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")

        def _denoise(self):
            request = service.request_id()
            with span("serve.request", request=request, device_work=not service.batching):
                with span("serve.decode"):
                    req = self._read()
                out = service.denoise(req, request)
                with span("serve.encode"):
                    self._send(200, out)

        def do_POST(self):
            try:
                if self.path == "/denoise":
                    return self._denoise()
                req = self._read()
                if self.path == "/request_trajectories":
                    self._send(200, service.request_trajectories(req))
                elif self.path == "/reconfigure":
                    self._send(200, service.reconfigure(req))
                else:
                    self._send(404, {"error": "unknown endpoint"})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": repr(e)})

        def log_message(self, fmt, *args):
            pass

    return Handler


def run_server(service: AgentService, host: str = "0.0.0.0", port: int = 8329, block: bool = True):
    """Serve ``service``; ``port`` 0 takes a free port (``httpd.server_address``).
    ``block=False`` serves from a daemon thread and returns the server; stop
    it with ``httpd.shutdown()``."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
