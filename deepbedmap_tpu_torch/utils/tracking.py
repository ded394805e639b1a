"""Experiment tracking: local + remote trackers behind one interface.

A copy of the framework-free ``deepbedmap_tpu/utils/tracking.py``: the port
cannot import it, since importing any ``deepbedmap_tpu`` module loads JAX.
The two read and write the same experiment layout and protocol.

The reference streams every run to Comet.ML — create/resume an experiment by
key (srgan_train.py:1497-1537), ``log_parameters``/``log_metrics`` per epoch
(srgan_train.py:1576-1640), upload weight assets and the model graph on the
final epoch (srgan_train.py:1673-1688), and later *fetch* weights back by
experiment key, including a 'latest' lookup
(features/environment.py:87-127, deepbedmap.py:381-410).

This module reimplements that capability tracker-agnostically:

- ``LocalTracker``  — directory-per-experiment store (JSONL records + assets);
                      resume-by-key = reopen the same key, 'latest' = newest
                      created_ts. Works with zero network.
- ``HTTPTracker``   — the same protocol over a Comet-style REST surface using
                      stdlib urllib (no SDK): POST records, PUT asset bytes,
                      GET asset/experiment lists. Any small service (or the
                      bundled test server) satisfies it.
- ``MultiTracker``  — fan-out (the reference logs to Comet *and* local files).
- ``download_model_weights`` — the weight-fetcher: resolve 'latest' or an
                      explicit key, download a named asset, return the
                      experiment's logged hyperparameters.

"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Dict, List, Optional


class Tracker:
    """Interface every tracker implements (the thin surface the reference's
    training loop needs from comet_ml.Experiment)."""

    experiment_key: str

    def log_params(self, params: Dict) -> None:
        raise NotImplementedError

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_asset(self, path: str, name: Optional[str] = None) -> None:
        raise NotImplementedError

    def set_model_graph(self, graph: str) -> None:
        raise NotImplementedError

    def end(self, status: str = "COMPLETE") -> None:
        pass

    # --- read-back side (comet_ml.API equivalent) ---
    def params(self) -> Dict:
        raise NotImplementedError

    def asset_list(self) -> List[str]:
        raise NotImplementedError

    def fetch_asset(self, name: str, download_path: str) -> str:
        raise NotImplementedError


class LocalTracker(Tracker):
    """Directory-per-experiment tracker.

    Layout: ``<root>/<key>/records.jsonl`` (params/metrics/status events),
    ``<root>/<key>/assets/<name>`` (uploaded files), ``<root>/<key>/graph.txt``.
    Passing an existing ``experiment_key`` resumes it (the reference's
    ExistingExperiment(previous_experiment=key), srgan_train.py:1504-1508).
    """

    def __init__(
        self,
        root: str,
        experiment_key: Optional[str] = None,
        create: bool = True,
    ):
        """``create=False`` opens an existing experiment read-only-safely:
        nothing is written or mkdir'd, and a missing key raises instead of
        minting a junk experiment (which would also poison 'latest')."""
        self.root = root
        self.experiment_key = experiment_key or uuid.uuid4().hex
        self.dir = os.path.join(root, self.experiment_key)
        self._records = os.path.join(self.dir, "records.jsonl")
        if create:
            os.makedirs(os.path.join(self.dir, "assets"), exist_ok=True)
            if not os.path.exists(self._records):
                self._write({"type": "created", "ts": time.time()})
        elif not os.path.exists(self._records):
            raise FileNotFoundError(
                f"no experiment {self.experiment_key!r} under {root}"
            )

    def _write(self, record: Dict) -> None:
        with open(self._records, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _read(self) -> List[Dict]:
        with open(self._records) as f:
            return [json.loads(line) for line in f if line.strip()]

    def log_params(self, params: Dict) -> None:
        self._write({"type": "params", "ts": time.time(), "params": params})

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._write(
            {"type": "metrics", "ts": time.time(), "step": step, "metrics": metrics}
        )

    def log_asset(self, path: str, name: Optional[str] = None) -> None:
        name = name or os.path.basename(path)
        shutil.copy2(path, os.path.join(self.dir, "assets", name))
        self._write({"type": "asset", "ts": time.time(), "name": name})

    def set_model_graph(self, graph: str) -> None:
        with open(os.path.join(self.dir, "graph.txt"), "w") as f:
            f.write(graph)

    def end(self, status: str = "COMPLETE") -> None:
        self._write({"type": "end", "ts": time.time(), "status": status})

    # --- read-back ---
    def params(self) -> Dict:
        out: Dict = {}
        for rec in self._read():
            if rec["type"] == "params":
                out.update(rec["params"])
        return out

    def metrics(self) -> List[Dict]:
        return [r for r in self._read() if r["type"] == "metrics"]

    def asset_list(self) -> List[str]:
        return sorted(os.listdir(os.path.join(self.dir, "assets")))

    def fetch_asset(self, name: str, download_path: str) -> str:
        dirname = os.path.dirname(download_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        shutil.copy2(os.path.join(self.dir, "assets", name), download_path)
        return download_path

    @staticmethod
    def _created_ts(records_path: str) -> float:
        with open(records_path) as f:
            first = f.readline()
        try:
            return float(json.loads(first).get("ts", 0.0))
        except (json.JSONDecodeError, ValueError):
            return 0.0

    @classmethod
    def list_experiments(cls, root: str) -> List[str]:
        """Experiment keys ordered by creation time (the 'created' record's
        timestamp, like the reference's start_server_timestamp sort,
        features/environment.py:108-110)."""
        if not os.path.isdir(root):
            return []
        keyed = [
            (cls._created_ts(os.path.join(root, k, "records.jsonl")), k)
            for k in os.listdir(root)
            if os.path.exists(os.path.join(root, k, "records.jsonl"))
        ]
        return [k for _, k in sorted(keyed)]

    @classmethod
    def latest(cls, root: str) -> "LocalTracker":
        keys = cls.list_experiments(root)
        if not keys:
            raise FileNotFoundError(f"no experiments under {root}")
        return cls(root, experiment_key=keys[-1], create=False)


class HTTPTracker(Tracker):
    """Remote tracker over a Comet-style REST surface (stdlib urllib only).

    Endpoints (all JSON unless noted):
      POST <base>/experiments                       {"key": ...} -> 200
      POST <base>/experiments/<key>/records         one event record
      PUT  <base>/experiments/<key>/assets/<name>   raw bytes
      GET  <base>/experiments                       -> {"experiments":
                                                        [{"key", "created_ts"}]}
      GET  <base>/experiments/<key>/params          -> {...}
      GET  <base>/experiments/<key>/assets          -> {"assets": ["name", ...]}
      GET  <base>/experiments/<key>/assets/<name>   -> raw bytes

    ``api_key`` is sent as an Authorization bearer header. Failures raise
    (urllib.error.*) — callers wanting best-effort logging wrap this in
    MultiTracker alongside a LocalTracker.
    """

    def __init__(
        self,
        base_url: str,
        experiment_key: Optional[str] = None,
        api_key: Optional[str] = None,
        timeout: float = 10.0,
        create: bool = True,
    ):
        """``create=False`` opens an existing experiment without POSTing a
        create — the pure-read mode ``download_model_weights`` uses."""
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout
        self.experiment_key = experiment_key or uuid.uuid4().hex
        if create:
            self._request(
                "POST",
                "/experiments",
                json_body={"key": self.experiment_key, "ts": time.time()},
            )

    def _request(self, method: str, path: str, json_body=None, raw_body=None):
        import urllib.request

        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        data = None
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        elif raw_body is not None:
            data = raw_body
            headers["Content-Type"] = "application/octet-stream"
        req = urllib.request.Request(
            self.base_url + path, data=data, headers=headers, method=method
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def _post_record(self, record: Dict) -> None:
        self._request(
            "POST", f"/experiments/{self.experiment_key}/records", json_body=record
        )

    def log_params(self, params: Dict) -> None:
        self._post_record({"type": "params", "ts": time.time(), "params": params})

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._post_record(
            {"type": "metrics", "ts": time.time(), "step": step, "metrics": metrics}
        )

    def log_asset(self, path: str, name: Optional[str] = None) -> None:
        name = name or os.path.basename(path)
        with open(path, "rb") as f:
            self._request(
                "PUT",
                f"/experiments/{self.experiment_key}/assets/{name}",
                raw_body=f.read(),
            )

    def set_model_graph(self, graph: str) -> None:
        self._post_record({"type": "graph", "ts": time.time(), "graph": graph})

    def end(self, status: str = "COMPLETE") -> None:
        self._post_record({"type": "end", "ts": time.time(), "status": status})

    # --- read-back ---
    def params(self) -> Dict:
        return json.loads(
            self._request("GET", f"/experiments/{self.experiment_key}/params")
        )

    def asset_list(self) -> List[str]:
        return json.loads(
            self._request("GET", f"/experiments/{self.experiment_key}/assets")
        )["assets"]

    def fetch_asset(self, name: str, download_path: str) -> str:
        blob = self._request(
            "GET", f"/experiments/{self.experiment_key}/assets/{name}"
        )
        dirname = os.path.dirname(download_path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(download_path, "wb") as f:
            f.write(blob)
        return download_path

    @classmethod
    def latest_key(
        cls, base_url: str, api_key: Optional[str] = None, timeout: float = 10.0
    ) -> str:
        import urllib.request

        headers = {"Authorization": f"Bearer {api_key}"} if api_key else {}
        req = urllib.request.Request(
            base_url.rstrip("/") + "/experiments", headers=headers
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            experiments = json.loads(resp.read())["experiments"]
        if not experiments:
            raise LookupError(f"no experiments at {base_url}")
        return max(experiments, key=lambda e: e["created_ts"])["key"]


class MultiTracker(Tracker):
    """Fan-out writes to several trackers; reads come from the first."""

    def __init__(self, trackers: List[Tracker]):
        assert trackers
        self.trackers = list(trackers)
        self.experiment_key = trackers[0].experiment_key

    def log_params(self, params):
        for t in self.trackers:
            t.log_params(params)

    def log_metrics(self, metrics, step):
        for t in self.trackers:
            t.log_metrics(metrics, step)

    def log_asset(self, path, name=None):
        for t in self.trackers:
            t.log_asset(path, name)

    def set_model_graph(self, graph):
        for t in self.trackers:
            t.set_model_graph(graph)

    def end(self, status="COMPLETE"):
        for t in self.trackers:
            t.end(status)

    def params(self):
        return self.trackers[0].params()

    def asset_list(self):
        return self.trackers[0].asset_list()

    def fetch_asset(self, name, download_path):
        return self.trackers[0].fetch_asset(name, download_path)


def download_model_weights(
    source,  # a Tracker, a local root dir, or an http(s) base URL
    experiment_key: str = "latest",
    asset_name: str = "srgan_generator_model_weights.npz",
    download_path: str = "model/weights/srgan_generator_model_weights.npz",
    api_key: Optional[str] = None,
) -> Dict:
    """Fetch trained weights (and the run's hyperparameters) by experiment key
    — the reference's `_download_model_weights_from_comet`
    (features/environment.py:87-127): 'latest' resolves to the newest
    experiment, the named npz asset is written to ``download_path``, and the
    experiment's logged params (num_residual_blocks, residual_scaling, ...)
    are returned so the caller can rebuild the matching model."""
    # pure read: never create/mutate experiments while fetching (a typo'd key
    # must raise, not mint a junk experiment that poisons 'latest')
    if isinstance(source, Tracker):
        tracker = source
    elif isinstance(source, str) and source.startswith(("http://", "https://")):
        key = (
            HTTPTracker.latest_key(source, api_key=api_key)
            if experiment_key == "latest"
            else experiment_key
        )
        tracker = HTTPTracker(
            source, experiment_key=key, api_key=api_key, create=False
        )
    else:
        tracker = (
            LocalTracker.latest(source)
            if experiment_key == "latest"
            else LocalTracker(source, experiment_key=experiment_key, create=False)
        )
    tracker.fetch_asset(asset_name, download_path)
    return tracker.params()
