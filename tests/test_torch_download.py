"""The port's checkpoint downloader (``tpuserve_torch/models/download.py``)
against the JAX package's: both modules run with ``huggingface_hub``
stubbed through ``sys.modules``, so nothing is fetched; they must snapshot
into the same target with the same ``allow_patterns`` and token, reuse a
complete snapshot the same way, and fail the same way without the hub."""

import sys
import types

import pytest

from tpuserve.models import download as jax_download
from tpuserve_torch.models import download


@pytest.fixture
def hub(monkeypatch):
    calls = []

    def snapshot_download(**kw):
        calls.append(kw)
    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(snapshot_download=snapshot_download))
    monkeypatch.delenv("HF_TOKEN", raising=False)
    return calls


@pytest.mark.parametrize("token", [None, "tok"])
def test_snapshot_target_and_patterns_equal_jax(hub, tmp_path, token):
    got = [mod.download_model("Org/Model", str(tmp_path / name), token=token)
           for mod, name in ((download, "port"), (jax_download, "jax"))]
    assert got == [str(tmp_path / "port" / "Org/Model"), str(tmp_path / "jax" / "Org/Model")]
    assert len(hub) == 2
    assert hub[0] == dict(hub[1], local_dir=got[0])
    assert hub[0]["repo_id"] == "Org/Model" and hub[0]["token"] == token
    assert hub[0]["allow_patterns"] == jax_download._WEIGHT_PATTERNS
    assert download._WEIGHT_PATTERNS == jax_download._WEIGHT_PATTERNS


def test_env_token_and_complete_snapshot_reuse_equal_jax(hub, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_TOKEN", "from-env")
    for mod, name in ((download, "port"), (jax_download, "jax")):
        mod.download_model("m", str(tmp_path / name))
    assert [c["token"] for c in hub] == ["from-env", "from-env"]
    # a config and a safetensors file: the snapshot is complete, reused
    for name in ("port", "jax"):
        (tmp_path / name / "m" / "config.json").write_text("{}")
        (tmp_path / name / "m" / "w.safetensors").write_bytes(b"")
    for mod, name in ((download, "port"), (jax_download, "jax")):
        assert mod.download_model("m", str(tmp_path / name)) == str(tmp_path / name / "m")
    assert len(hub) == 2
    # a config alone is not complete: fetched again
    (tmp_path / "port" / "n").mkdir()
    (tmp_path / "port" / "n" / "config.json").write_text("{}")
    download.download_model("n", str(tmp_path / "port"))
    assert len(hub) == 3


def test_main_and_missing_hub_equal_jax(hub, tmp_path, monkeypatch):
    download.main(["--model", "a/b", "--out", str(tmp_path)])
    assert hub[-1]["repo_id"] == "a/b" and hub[-1]["local_dir"] == str(tmp_path / "a/b")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    msgs = []
    for mod in (download, jax_download):
        with pytest.raises(RuntimeError) as ei:
            mod.download_model("c", str(tmp_path / mod.__name__))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "huggingface_hub is required" in msgs[0]
