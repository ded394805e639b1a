"""Content-addressed dataset packaging (the reference's quilt role).

The reference builds its five training arrays into a quilt package and
restores them by hash (data_prep.py:938-970 ``quilt.build``/``push``,
srgan_train.py:87-125 ``quilt.install(..., hash=...)`` +
``quilt.load``). This module provides the same contract against a local
(or network-mounted) registry directory, with sha256 content addressing:

  registry/
    blobs/<sha256>                       — deduplicated member payloads
    packages/<name>/<package_hash>.json  — manifest: members -> blob hashes
    packages/<name>/latest               — pointer to the newest hash

A package hash is the sha256 of the sorted (member, blob-hash) pairs, so it
pins the exact bytes of every member — the same identity quilt's hash
carried. ``install``/``load_arrays`` verify every blob on the way out, so a
corrupted registry fails loudly instead of training on damaged tiles.

A copy of ``deepbedmap_tpu/data/packaging.py``: the two packages read and
write the same registries.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Optional

from deepbedmap_tpu_torch.data.manifest import check_sha256


def _pkg_dir(registry: str, name: str) -> str:
    # package names may be slash-namespaced like 'weiji14/deepbedmap/model'
    return os.path.join(registry, "packages", *name.split("/"))


def build_manifest(files: Dict[str, str]) -> Dict:
    """Hash the member files of a package: {member_name: path} ->
    manifest dict (no copying; ``push`` persists it)."""
    members = {}
    for member, path in sorted(files.items()):
        members[member] = {
            "sha256": check_sha256(path),
            "bytes": os.path.getsize(path),
        }
    pkg_hash = hashlib.sha256(
        json.dumps(
            [(m, v["sha256"]) for m, v in sorted(members.items())]
        ).encode()
    ).hexdigest()
    return {"hash": pkg_hash, "members": members}


def push(
    name: str, files: Dict[str, str], registry: str, meta: Optional[Dict] = None
) -> str:
    """Build + persist a package version; returns its hash. Blobs are
    deduplicated across versions and packages."""
    manifest = build_manifest(files)
    manifest["name"] = name
    manifest["created"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    if meta:
        manifest["meta"] = meta

    blob_dir = os.path.join(registry, "blobs")
    os.makedirs(blob_dir, exist_ok=True)
    for member, info in manifest["members"].items():
        blob = os.path.join(blob_dir, info["sha256"])
        if not os.path.exists(blob):
            shutil.copyfile(files[member], blob + ".tmp")
            os.replace(blob + ".tmp", blob)

    pdir = _pkg_dir(registry, name)
    os.makedirs(pdir, exist_ok=True)
    with open(os.path.join(pdir, manifest["hash"] + ".json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    with open(os.path.join(pdir, "latest"), "w") as f:
        f.write(manifest["hash"])
    return manifest["hash"]


def resolve(registry: str, name: str, pkg_hash: Optional[str] = None) -> Dict:
    """Load a package manifest by hash (or the latest)."""
    pdir = _pkg_dir(registry, name)
    if pkg_hash is None:
        with open(os.path.join(pdir, "latest")) as f:
            pkg_hash = f.read().strip()
    path = os.path.join(pdir, pkg_hash + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"package {name}@{pkg_hash} not in {registry}")
    with open(path) as f:
        manifest = json.load(f)
    if manifest["hash"] != pkg_hash:
        raise ValueError(f"manifest hash mismatch for {name}@{pkg_hash}")
    return manifest


def versions(registry: str, name: str) -> List[Dict]:
    """All versions of a package, newest first."""
    pdir = _pkg_dir(registry, name)
    out = []
    for fn in os.listdir(pdir):
        if fn.endswith(".json"):
            with open(os.path.join(pdir, fn)) as f:
                out.append(json.load(f))
    return sorted(out, key=lambda m: m.get("created", ""), reverse=True)


def install(
    registry: str,
    name: str,
    dest: str,
    pkg_hash: Optional[str] = None,
    force: bool = False,
) -> Dict:
    """Materialise a package's members into ``dest``, verifying each blob's
    sha256 (quilt.install's role, srgan_train.py:96-99). Existing files with
    the right hash are kept unless ``force``."""
    manifest = resolve(registry, name, pkg_hash)
    os.makedirs(dest, exist_ok=True)
    for member, info in manifest["members"].items():
        out = os.path.join(dest, member)
        if not force and os.path.exists(out) and check_sha256(out) == info["sha256"]:
            continue
        blob = os.path.join(registry, "blobs", info["sha256"])
        got = check_sha256(blob)
        if got != info["sha256"]:
            raise ValueError(
                f"registry blob corrupted for {member}: {got} != {info['sha256']}"
            )
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        shutil.copyfile(blob, out)
    return manifest


def load_arrays(
    registry: str, name: str, pkg_hash: Optional[str] = None
) -> Dict[str, "object"]:
    """Load every ``*.npy`` member directly from verified blobs
    (quilt.load's role) -> {member_stem: ndarray}."""
    import numpy as np

    manifest = resolve(registry, name, pkg_hash)
    out = {}
    for member, info in manifest["members"].items():
        if not member.endswith(".npy"):
            continue
        blob = os.path.join(registry, "blobs", info["sha256"])
        if check_sha256(blob) != info["sha256"]:
            raise ValueError(f"registry blob corrupted for {member}")
        out[os.path.splitext(member)[0]] = np.load(blob)
    return out


def push_training_arrays(
    model_dir: str, registry: str, name: str = "deepbedmap/model/train"
) -> str:
    """Package the builder's X/W1/W2/W3/Y arrays + CONTENT_HASH from
    ``model_dir`` (data.builder.build_training_arrays out_dir) — the
    reference's 'weiji14/deepbedmap/model/train' bundle."""
    files = {}
    for key in ("X", "W1", "W2", "W3", "Y"):
        path = os.path.join(model_dir, f"{key}_data.npy")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        files[f"{key}_data.npy"] = path
    ch = os.path.join(model_dir, "CONTENT_HASH")
    meta = None
    if os.path.exists(ch):
        with open(ch) as f:
            meta = {"content_hash": f.read().strip()}
    return push(name, files, registry, meta=meta)
