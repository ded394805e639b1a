"""Dataset manifest: download, integrity, catalogue (reference L0,
data_prep.py:69-242 + data_list.yml).

The manifest format is the reference's YAML schema verbatim (folder, filename,
url, sha256, doi, resolution per record); this module parses it, downloads with
archive-member extraction, and verifies sha256 — all host-side stdlib.

A copy of ``deepbedmap_tpu/data/manifest.py`` with its ``datasets.yml``; the
port cannot import it, since importing any ``deepbedmap_tpu`` module loads
JAX. ``yaml`` is imported inside ``parse_datalist``, so the module imports
where PyYAML is not installed.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.request
import zipfile
from typing import Dict, List, Optional


DEFAULT_MANIFEST = os.path.join(os.path.dirname(__file__), "datasets.yml")


def parse_datalist(yaml_file: str = DEFAULT_MANIFEST) -> List[Dict]:
    """YAML manifest -> list of file records. Understands both this package's
    flat schema (``datasets.yml``: top-level ``files`` list with name/folder/
    url/sha256/resolution fields) and the reference's nested group schema
    (data_list.yml, data_prep.py:133-166)."""
    import yaml

    with open(yaml_file) as f:
        doc = yaml.safe_load(f)
    records: List[Dict] = []
    if isinstance(doc, dict) and "files" in doc:  # flat schema
        for entry in doc["files"]:
            record = dict(entry)
            record.setdefault("filename", record.get("name"))
            records.append(record)
        return records
    for group in doc:  # reference nested schema
        files = group.get("files", [group])
        for entry in files:
            record = {**{k: v for k, v in group.items() if k != "files"}, **entry}
            records.append(record)
    return records


def check_sha256(path: str) -> str:
    """Streaming sha256 of a file (reference check_sha256, data_prep.py:111-126)."""
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def download_to_path(
    path: str, url: str, member: Optional[str] = None, overwrite: bool = False
) -> str:
    """Fetch a URL to ``path``; if the URL is a tgz/zip archive, extract
    ``member`` (or the basename of ``path``) from it
    (reference download_to_path, data_prep.py:69-107)."""
    if os.path.exists(path) and not overwrite:
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    if url.endswith((".tgz", ".tar.gz", ".zip")):
        archive_path = path + os.path.splitext(url)[1]
        urllib.request.urlretrieve(url, archive_path)
        wanted = member or os.path.basename(path)
        if url.endswith(".zip"):
            with zipfile.ZipFile(archive_path) as zf:
                names = [n for n in zf.namelist() if os.path.basename(n) == wanted]
                assert names, f"{wanted} not in {url}"
                with zf.open(names[0]) as src, open(path, "wb") as dst:
                    shutil.copyfileobj(src, dst)
        else:
            with tarfile.open(archive_path) as tf:
                names = [n for n in tf.getnames() if os.path.basename(n) == wanted]
                assert names, f"{wanted} not in {url}"
                with tf.extractfile(names[0]) as src, open(path, "wb") as dst:
                    shutil.copyfileobj(src, dst)
        os.remove(archive_path)
    else:
        urllib.request.urlretrieve(url, path)
    return path


def write_catalog_markdown(
    yaml_file: str = DEFAULT_MANIFEST, out_path: Optional[str] = None
) -> str:
    """Markdown table of the dataset catalogue (the reference autogenerates
    folder READMEs from its manifest, data_prep.py:170-205)."""
    records = parse_datalist(yaml_file)
    lines = [
        "| Filename | Group | Folder | Resolution | DOI |",
        "|---|---|---|---|---|",
    ]
    for r in records:
        lines.append(
            f"| [{r['filename']}]({r.get('url', '')}) | {r.get('group', r.get('citekey', ''))} "
            f"| {r.get('folder', '')} | {r.get('resolution', '')} "
            f"| {r.get('doi', '')} |"
        )
    text = "\n".join(lines) + "\n"
    if out_path is not None:
        with open(out_path, "w") as f:
            f.write(text)
    return text


def write_folder_readmes(
    data_dir: str, yaml_file: str = DEFAULT_MANIFEST
) -> List[str]:
    """Autogenerate ``<folder>/README.md`` per data folder from the manifest
    (reference data_prep.py:168-205): one row per dataset GROUP, with
    multi-file groups collapsed to "N *<ext> files", resolution and the
    literature/data DOIs. Returns the paths written."""
    import collections

    records = parse_datalist(yaml_file)
    by_folder: Dict[str, List[Dict]] = collections.defaultdict(list)
    for r in records:
        by_folder[r.get("folder", "misc")].append(r)

    titles = {
        "lowres": "Low Resolution",
        "highres": "High Resolution",
        "misc": "Miscellaneous",
    }
    written: List[str] = []
    for folder, recs in sorted(by_folder.items()):
        out_dir = os.path.join(data_dir, folder)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "README.md")
        groups: Dict[str, List[Dict]] = collections.defaultdict(list)
        for r in recs:
            groups[r.get("group", r["filename"])].append(r)
        lines = [
            f"# {titles.get(folder, folder.title())} Antarctic datasets",
            "",
            "Note: this file was automatically generated from "
            "[datasets.yml](/deepbedmap_tpu_torch/data/datasets.yml) by "
            "`deepbedmap_tpu_torch.data.manifest.write_folder_readmes` "
            "(reference: data_prep.py:168-205).",
            "",
            "| Filename | Resolution | Citation | Data DOI |",
            "|---|---|---|---|",
        ]
        for group, rs in sorted(groups.items()):
            if len(rs) == 1:
                fname = rs[0]["filename"]
            else:
                ext = os.path.splitext(rs[0]["filename"])[-1]
                fname = f"{len(rs)} *{ext} files"
            doi = rs[0].get("doi", "")
            doi_md = f"[DOI]({doi})" if doi else ""
            lines.append(
                f"| {fname} | {rs[0].get('resolution', '')} "
                f"| {group} | {doi_md} |"
            )
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        written.append(path)
    return written


def verify_datalist(
    yaml_file: str, root: str = ".", strict: bool = True
) -> Dict[str, bool]:
    """Verify sha256 of every manifest file present on disk; returns
    {path: ok}. strict=True raises on mismatch (the reference asserts,
    data_prep.py:211-242)."""
    results: Dict[str, bool] = {}
    for record in parse_datalist(yaml_file):
        if "filename" not in record or "sha256" not in record:
            continue
        path = os.path.join(root, record.get("folder", ""), record["filename"])
        if not os.path.exists(path):
            continue
        ok = check_sha256(path) == record["sha256"]
        results[path] = ok
        if strict and not ok:
            raise AssertionError(f"sha256 mismatch for {path}")
    return results
