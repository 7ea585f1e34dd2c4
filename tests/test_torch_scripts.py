"""The port's counterparts of the JAX package's user scripts:
`scripts/visualize_torch.py` (its PLY writer, and a prediction dump end to
end on a tiny checkpoint on the CPU, importing no JAX),
`scripts/parity_torch.py` (the JAX script's train and evaluate argument
lists, plus `--device`) and `scripts/prepare_data_torch.py` (the same
files as the JAX script's from the same inputs)."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from scripts import parity as jparity  # noqa: E402
from scripts import parity_torch  # noqa: E402
from scripts import prepare_data as jprep  # noqa: E402
from scripts import prepare_data_torch as tprep  # noqa: E402
from scripts.visualize_torch import (  # noqa: E402
    _PALETTE, labels_to_colors, write_ply)

torch.set_num_threads(1)


def _read_ply(path):
    header, body = open(path, "rb").read().split(b"end_header\n", 1)
    return (header.decode("ascii").splitlines(),
            np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)]))


def test_write_ply_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    labels = rng.integers(0, 25, 500)          # exercises palette cycling
    colors = labels_to_colors(labels)
    assert colors.dtype == np.uint8 and colors.shape == (500, 3)
    sel = colors[labels == 22]
    np.testing.assert_array_equal(
        sel, np.tile(_PALETTE[22 % len(_PALETTE)], (len(sel), 1)))

    path = str(tmp_path / "out.ply")
    write_ply(path, xyz, colors)
    lines, rec = _read_ply(path)
    assert lines[0] == "ply" and "element vertex 500" in lines
    assert len(rec) == 500
    np.testing.assert_array_equal(rec["xyz"], xyz)
    np.testing.assert_array_equal(rec["rgb"], colors)
    with pytest.raises(ValueError):
        write_ply(path, xyz, colors[:10])


def test_visualize_end_to_end_on_the_cpu(tmp_path):
    """A tiny seg checkpoint from the port's trainer state, dumped by the
    script in a fresh process with --device cpu; in the same process the
    parity and prepare-data scripts stop on an empty data root; the
    process imports nothing of JAX or the JAX package."""
    from gridgcn_torch.configs import presets
    from gridgcn_torch.configs.base import apply_overrides
    from gridgcn_torch.models.build import init_model
    from gridgcn_torch.train import steps
    from gridgcn_torch.utils import jaxrng
    from gridgcn_torch.utils.checkpoint import CheckpointManager

    ck = str(tmp_path / "ck")
    cfg = apply_overrides(presets.get("synthetic_tiny_seg"),
                          {"train.ckpt_dir": ck})
    model, sd = init_model(cfg.model, torch.Generator().manual_seed(0))
    state = steps.create_train_state(cfg, model, sd, 8, device="cpu")
    CheckpointManager(ck, cfg).save(0, state, jaxrng.PRNGKey(0))

    out = str(tmp_path / "scene.ply")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['visualize_torch.py', '--ckpt-dir', {ck!r}, '--out', "
        f"{out!r}, '--num-points', '600', '--votes', '2', '--truth', "
        "'--device', 'cpu']\n"
        "try:\n"
        f"    runpy.run_path({str(REPO / 'scripts' / 'visualize_torch.py')!r},"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "from scripts import parity_torch, prepare_data_torch\n"
        f"assert parity_torch.main(['--dataset', 's3dis', '--root', "
        f"{str(tmp_path)!r}, '--device', 'cpu']) == 1\n"
        f"assert prepare_data_torch.check({str(tmp_path)!r}) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gridgcn_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'gridgcn_torch.train.train' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "wrote 600 points" in res.stdout, res.stdout
    _, rec = _read_ply(out)
    _, truth = _read_ply(out + ".truth.ply")
    assert len(rec) == len(truth) == 600
    np.testing.assert_array_equal(rec["xyz"], truth["xyz"])
    palette = {tuple(c) for c in _PALETTE[:cfg.model.num_classes]}
    assert {tuple(c) for c in rec["rgb"]} <= palette


@pytest.mark.parametrize("dataset,fold,skip", [
    ("modelnet40", None, False), ("s3dis", None, False), ("s3dis", 3, False),
    ("scannet", None, False), ("scannet", None, True)])
def test_parity_argument_lists_are_the_jax_scripts(monkeypatch, tmp_path,
                                                   dataset, fold, skip):
    """Both scripts with their train and evaluate mains replaced by
    recorders: the port's lists are the JAX script's plus `--device`."""
    import gridgcn_tpu.train.evaluate as jeval
    import gridgcn_tpu.train.train as jtrain
    import gridgcn_torch.train.evaluate as teval
    import gridgcn_torch.train.train as ttrain

    calls = []
    for mod, tag in ((jtrain, "jtrain"), (jeval, "jeval"),
                     (ttrain, "ttrain"), (teval, "teval")):
        monkeypatch.setattr(mod, "main",
                            lambda argv, tag=tag: calls.append((tag, argv)))
    monkeypatch.setattr(jprep, "check", lambda root, dataset=None: 0)
    monkeypatch.setattr(tprep, "check", lambda root, dataset=None: 0)
    argv = ["--dataset", dataset, "--root", str(tmp_path), "train.epochs=2"]
    argv += ["--fold", str(fold)] if fold else []
    argv += ["--skip-train"] if skip else []
    assert jparity.main(argv) == 0
    assert parity_torch.main(argv + ["--device", "cpu"]) == 0
    got = dict(calls)
    assert len(got) == len(calls) == (2 if skip else 4)
    for j, t in (("jtrain", "ttrain"), ("jeval", "teval")):
        if skip and j == "jtrain":
            continue
        assert got[t] == got[j] + ["--device", "cpu"], (got[j], got[t])
    assert "--target" in got["teval"]


def test_parity_stops_on_a_missing_layout(tmp_path, capsys):
    assert parity_torch.main(["--dataset", "scannet", "--root",
                              str(tmp_path), "--device", "cpu"]) == 1
    assert "dataset files missing" in capsys.readouterr().err


def _s3dis_hdf5(root: Path):
    """The HDF5 layout that tests/test_torch_data.py writes."""
    h5py = pytest.importorskip("h5py")
    h5dir = root / "s3dis" / "indoor3d_sem_seg_hdf5_data"
    h5dir.mkdir(parents=True)
    rng = np.random.default_rng(2)
    with h5py.File(h5dir / "ply_data_all_0.h5", "w") as h5:
        h5["data"] = rng.uniform(0, 1, (6, 512, 9)).astype(np.float32)
        h5["label"] = rng.integers(0, 13, (6, 512)).astype(np.uint8)
    (h5dir / "all_files.txt").write_text(
        "indoor3d_sem_seg_hdf5_data/ply_data_all_0.h5\n")
    rooms = ["Area_1_office_1"] * 3 + ["Area_5_office_1"] * 2 + [
        "Area_3_hall_2"]
    (h5dir / "room_filelist.txt").write_text("\n".join(rooms) + "\n")


def _files(root: Path) -> dict:
    files = {p.relative_to(root).as_posix(): p for p in root.rglob("*")
             if p.is_file() and p.suffix in (".npy", ".txt")}
    return {k: v for k, v in files.items() if "hdf5" not in k}


@pytest.mark.parametrize("holdout", ["Area_5", "Area_3"])
def test_s3dis_from_hdf5_writes_the_jax_scripts_files(tmp_path, holdout):
    j, t = tmp_path / "j", tmp_path / "t"
    _s3dis_hdf5(j)
    _s3dis_hdf5(t)
    assert jprep.s3dis_from_hdf5(str(j), holdout) == 0
    assert tprep.main(["s3dis", "--root", str(t), "--holdout", holdout]) == 0
    fj, ft = _files(j), _files(t)
    assert sorted(fj) == sorted(ft) and len(fj) == 7, sorted(ft)
    for name in fj:
        if name.endswith(".txt"):
            assert fj[name].read_text() == ft[name].read_text()
            continue
        a, b = np.load(fj[name]), np.load(ft[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_check_and_scannet_pickle_match_the_jax_script(tmp_path, capsys):
    rng = np.random.default_rng(4)
    scenes = [(rng.uniform(0, 5, (n, 6)).astype(np.float32),
               rng.integers(0, 21, n)) for n in (300, 70)]
    pk = tmp_path / "scannet_train.pickle"
    pk.write_bytes(pickle.dumps(scenes))
    for mod, root in ((jprep, tmp_path / "j"), (tprep, tmp_path / "t")):
        assert mod.check(str(root), dataset="scannet") == 1
        assert mod.scannet_from_pickle(str(root), str(pk), "test") == 0
        assert mod.check(str(root), dataset="scannet") == 0
        assert mod.check(str(root)) == 1
    out = capsys.readouterr().out.replace(str(tmp_path / "j"), "ROOT")
    half = out.splitlines()
    n = len(half) // 2
    assert "\n".join(half[:n]) == "\n".join(half[n:]).replace(
        str(tmp_path / "t"), "ROOT")
    for split in ("points", "labels"):
        a = np.load(tmp_path / "j" / "scannet" / f"scannet_test_{split}.npy",
                    allow_pickle=True)
        b = np.load(tmp_path / "t" / "scannet" / f"scannet_test_{split}.npy",
                    allow_pickle=True)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
