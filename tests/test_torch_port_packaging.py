"""PyTorch port: the dataset manifest and the content-addressed packages
(``deepbedmap_tpu_torch/data/{manifest,packaging}.py``), ``TileDataset``'s
package and npy routes, and the CLI's ``verify-data``, ``package-data`` and
``catalog``.

The cases of ``tests/test_packaging.py`` (but its live curves, which are
``viz/live.py``'s) and the manifest cases of
``tests/test_manifest_pipeline.py`` (but the download, which no test calls,
and the survey pipeline, which is not ported) on the port's modules; then
the port against JAX on the same files: ``TileDataset.from_package`` equal
to JAX's array for array, exactly; each CLI command's JSON equal to JAX's
(``package-data list`` up to the creation times); the catalog table byte
for byte.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepbedmap_tpu import cli as jax_cli
from deepbedmap_tpu.data import manifest as jax_manifest
from deepbedmap_tpu.data.dataset import TileDataset as JaxTileDataset
from deepbedmap_tpu_torch.cli import main
from deepbedmap_tpu_torch.data import packaging
from deepbedmap_tpu_torch.data.dataset import REFERENCE_SHAPES_NCHW, TileDataset
from deepbedmap_tpu_torch.data.manifest import (
    DEFAULT_MANIFEST,
    check_sha256,
    parse_datalist,
    verify_datalist,
    write_catalog_markdown,
    write_folder_readmes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "deepbedmap/model/train"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and PyTorch's default of one thread per core
    in each worker oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_dir(tmp_path, n=3, seed=0):
    d = tmp_path / "model"
    d.mkdir()
    rs = np.random.RandomState(seed)
    for k, shp in REFERENCE_SHAPES_NCHW.items():
        np.save(d / f"{k}_data.npy", rs.rand(n, *shp).astype(np.float32))
    (d / "CONTENT_HASH").write_text("deadbeef\n")
    return str(d)


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_push_install_roundtrip(tmp_path):
    model = _model_dir(tmp_path)
    registry = str(tmp_path / "registry")
    h = packaging.push_training_arrays(model, registry)
    assert len(h) == 64

    dest = str(tmp_path / "restored")
    manifest = packaging.install(registry, NAME, dest, pkg_hash=h)
    assert manifest["meta"]["content_hash"] == "deadbeef"
    for k in REFERENCE_SHAPES_NCHW:
        a = np.load(os.path.join(model, f"{k}_data.npy"))
        b = np.load(os.path.join(dest, f"{k}_data.npy"))
        np.testing.assert_array_equal(a, b)


def test_load_by_hash_pins_the_version(tmp_path):
    registry = str(tmp_path / "registry")
    h1 = packaging.push_training_arrays(_model_dir(tmp_path, seed=1), registry)
    d2 = tmp_path / "v2"
    d2.mkdir()
    h2 = packaging.push_training_arrays(_model_dir(d2, seed=2), registry)
    assert h1 != h2
    # latest resolves to v2; explicit hash restores v1 exactly
    assert packaging.resolve(registry, NAME)["hash"] == h2
    ds1 = TileDataset.from_package(registry, pkg_hash=h1, device="cpu")
    ds2 = TileDataset.from_package(registry, device="cpu")
    assert len(ds1) == len(ds2) == 3
    assert not torch.equal(ds1.arrays["Y"], ds2.arrays["Y"])
    vs = packaging.versions(registry, NAME)
    assert {m["hash"] for m in vs} == {h1, h2}


def test_corrupted_blob_fails_loudly(tmp_path):
    registry = str(tmp_path / "registry")
    h = packaging.push_training_arrays(_model_dir(tmp_path), registry)
    manifest = packaging.resolve(registry, NAME, h)
    blob = os.path.join(registry, "blobs", manifest["members"]["Y_data.npy"]["sha256"])
    with open(blob, "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff")
    with pytest.raises(ValueError, match="corrupt"):
        packaging.load_arrays(registry, NAME, h)
    with pytest.raises(ValueError, match="corrupt"):
        packaging.install(registry, NAME, str(tmp_path / "x"), pkg_hash=h)
    with pytest.raises(ValueError, match="corrupt"):
        TileDataset.from_package(registry, pkg_hash=h, device="cpu")


def test_blob_dedup_across_versions(tmp_path):
    registry = str(tmp_path / "registry")
    model = _model_dir(tmp_path)
    h1 = packaging.push_training_arrays(model, registry)
    h2 = packaging.push_training_arrays(model, registry)  # identical content
    assert h1 == h2
    assert len(os.listdir(os.path.join(registry, "blobs"))) == 5  # stored once


def test_cli_package_roundtrip_in_a_new_process(tmp_path):
    model = _model_dir(tmp_path)
    registry = str(tmp_path / "registry")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(*argv):
        out = subprocess.run(
            [sys.executable, "-m", "deepbedmap_tpu_torch", *argv],
            capture_output=True, text=True, env=env, check=True, cwd=ROOT,
        )
        return json.loads(out.stdout.strip().splitlines()[-1])

    pushed = run("package-data", "push", "--registry", registry, "--model-dir", model)
    listed = run("package-data", "list", "--registry", registry)
    got = run("package-data", "install", "--registry", registry,
              "--dest", str(tmp_path / "dest"), "--hash", pushed["hash"])
    assert listed["versions"][0]["hash"] == pushed["hash"]
    assert got["hash"] == pushed["hash"]
    assert os.path.exists(tmp_path / "dest" / "X_data.npy")


def test_folder_readmes(tmp_path):
    written = write_folder_readmes(str(tmp_path))
    folders = {os.path.basename(os.path.dirname(p)) for p in written}
    assert {"lowres", "highres", "misc"} <= folders
    text = open(os.path.join(str(tmp_path), "lowres", "README.md")).read()
    assert "Low Resolution Antarctic datasets" in text
    assert "bedmap2_bed.tif" in text
    assert "automatically generated" in text
    # multi-file groups collapse to a count (the 11-survey highres folder)
    hi = open(os.path.join(str(tmp_path), "highres", "README.md")).read()
    assert "files" in hi and "| 1000m |" not in hi.split("\n")[0]


def test_bundled_manifest_parses():
    records = parse_datalist(DEFAULT_MANIFEST)
    assert len(records) == 33  # the reference's 33 source files
    names = {r["filename"] for r in records}
    assert "bedmap2_bed.tif" in names
    assert "REMA_100m_dem.tif" in names
    for r in records:
        assert r["sha256"] and r["url"], r
    assert records == jax_manifest.parse_datalist(jax_manifest.DEFAULT_MANIFEST)


def test_check_sha256(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"deepbedmap")
    assert check_sha256(str(p)) == hashlib.sha256(b"deepbedmap").hexdigest()


def _manifest_with_files(tmp_path):
    import yaml

    good, bad = b"some raster bytes", b"other bytes"
    (tmp_path / "lowres").mkdir()
    (tmp_path / "lowres" / "a.tif").write_bytes(good)
    (tmp_path / "lowres" / "b.tif").write_bytes(bad)
    manifest = {
        "files": [
            {"name": "a.tif", "folder": "lowres", "url": "http://example/a.tif",
             "sha256": hashlib.sha256(good).hexdigest(), "group": "A2020"},
            {"name": "b.tif", "folder": "lowres", "url": "http://example/b.tif",
             "sha256": "1" * 64, "group": "B2021"},
            {"name": "missing.tif", "folder": "lowres", "url": "u", "sha256": "0" * 64},
        ]
    }
    mpath = tmp_path / "m.yml"
    mpath.write_text(yaml.safe_dump(manifest))
    return str(mpath)


def test_verify_datalist(tmp_path):
    mpath = _manifest_with_files(tmp_path)
    results = verify_datalist(mpath, root=str(tmp_path), strict=False)
    assert results == {str(tmp_path / "lowres" / "a.tif"): True,
                       str(tmp_path / "lowres" / "b.tif"): False}
    with pytest.raises(AssertionError, match="sha256 mismatch"):
        verify_datalist(mpath, root=str(tmp_path))


def test_dataset_hash_pinning(tmp_path):
    ds = TileDataset.synthetic(4, seed=0, device="cpu")
    h = ds.save_npy_dir(str(tmp_path / "train"))
    back = TileDataset.load_npy_dir(str(tmp_path / "train"), expected_hash=h, device="cpu")
    assert len(back) == 4
    with pytest.raises(ValueError):
        TileDataset.load_npy_dir(str(tmp_path / "train"), expected_hash="0" * 64,
                                 device="cpu")
    # the `build` layout, X_data.npy, ...
    for k in REFERENCE_SHAPES_NCHW:
        os.rename(tmp_path / "train" / f"{k}.npy", tmp_path / "train" / f"{k}_data.npy")
    back = TileDataset.load_npy_dir(str(tmp_path / "train"), expected_hash=h, device="cpu",
                                    suffix="_data")
    for k in REFERENCE_SHAPES_NCHW:
        assert torch.equal(back.arrays[k], ds.arrays[k])


def test_from_package_equals_jax(tmp_path):
    registry = str(tmp_path / "registry")
    h = packaging.push_training_arrays(_model_dir(tmp_path, n=5, seed=4), registry)
    ours = TileDataset.from_package(registry, NAME, h, device="cpu")
    theirs = JaxTileDataset.from_package(registry, NAME, h)
    assert set(ours.arrays) == set(theirs.arrays)
    for k, v in theirs.arrays.items():
        np.testing.assert_array_equal(ours.arrays[k].numpy(), np.asarray(v), err_msg=k)
        assert ours.arrays[k].dtype == torch.float32


def test_cli_package_data_equals_jax(tmp_path, capsys):
    # both CLIs push the same arrays to registries of their own, then each
    # lists and installs; the port's registry is read by JAX's CLI too
    model = _model_dir(tmp_path)
    out = {}
    for tag, run in (("jax", jax_cli.main), ("port", main)):
        reg = str(tmp_path / f"reg_{tag}")
        assert run(["package-data", "push", "--registry", reg, "--model-dir", model]) == 0
        pushed = _json(capsys)
        assert run(["package-data", "list", "--registry", reg]) == 0
        listed = _json(capsys)
        assert run(["package-data", "install", "--registry", reg, "--dest",
                    str(tmp_path / f"dest_{tag}"), "--hash", pushed["hash"]]) == 0
        installed = _json(capsys)
        for v in listed["versions"]:
            v.pop("created")
        out[tag] = (pushed, listed, installed)
    assert out["port"] == out["jax"]
    train_hash = out["port"][0]["hash"]
    files = [str(tmp_path / "model" / "X_data.npy"), str(tmp_path / "model" / "Y_data.npy")]
    for tag, run in (("jax", jax_cli.main), ("port", main)):
        assert run(["package-data", "push", "--registry", str(tmp_path / f"reg_{tag}"),
                    "--name", "extra", "--files", *files]) == 0
        out[tag] = _json(capsys)
    assert out["port"] == out["jax"]
    # JAX's CLI installs the port's package (the latest of the default name)
    assert jax_cli.main(["package-data", "install", "--registry", str(tmp_path / "reg_port"),
                         "--dest", str(tmp_path / "cross")]) == 0
    assert _json(capsys)["hash"] == train_hash
    for k in REFERENCE_SHAPES_NCHW:
        assert (tmp_path / "cross" / f"{k}_data.npy").read_bytes() == \
            (tmp_path / "model" / f"{k}_data.npy").read_bytes()


def test_cli_verify_data_and_catalog_equal_jax(tmp_path, capsys):
    mpath = _manifest_with_files(tmp_path)
    argv = ["verify-data", "--datalist", mpath, "--root", str(tmp_path)]
    assert jax_cli.main(argv) == 1  # b.tif's hash is wrong
    want = _json(capsys)
    assert main(argv) == 1
    assert _json(capsys) == want
    assert want["present"] == 2 and want["ok"] == 1
    # the bundled manifest over an empty root: nothing present, all fine
    assert main(["verify-data", "--root", str(tmp_path / "empty")]) == 0
    assert _json(capsys) == {"command": "verify-data", "manifest_files": 33,
                             "present": 0, "ok": 0, "bad": []}

    for tag, run in (("jax", jax_cli.main), ("port", main)):
        root = tmp_path / f"data_{tag}"
        assert run(["catalog", "--root", str(root), "--catalog",
                    str(root / "CATALOG.md")]) == 0
        written = _json(capsys)["written"]
        assert [os.path.relpath(p, root) for p in written] == [
            "highres/README.md", "lowres/README.md", "misc/README.md", "CATALOG.md"]
    port, jax = tmp_path / "data_port", tmp_path / "data_jax"
    assert (port / "CATALOG.md").read_bytes() == (jax / "CATALOG.md").read_bytes()
    assert write_catalog_markdown(DEFAULT_MANIFEST) == jax_manifest.write_catalog_markdown(
        jax_manifest.DEFAULT_MANIFEST)
    for folder in ("highres", "lowres", "misc"):
        ours = (port / folder / "README.md").read_text()
        theirs = (jax / folder / "README.md").read_text()
        # one line names the generating module: each package names its own
        assert ours.replace("deepbedmap_tpu_torch", "deepbedmap_tpu") == theirs
