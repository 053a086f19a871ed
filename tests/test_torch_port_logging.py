"""tripled_tpu_torch/utils/logging.py's TensorBoard mirror and
`profile_trace`, and data/feature_match.py against the JAX package's
`extract_match` (cv2's ORB; skips where cv2 does not import)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tripled_tpu.data.feature_match import extract_match as jax_extract_match
from tripled_tpu_torch.data.feature_match import extract_match
from tripled_tpu_torch.utils.logging import MetricLogger, profile_trace

torch.set_num_threads(1)


def test_tensorboard_mirror_reads_back(tmp_path, monkeypatch):
    # TensorBoard as it is installed on its own, without TensorFlow (which
    # it would import here, for 13 s); its writer and reader need neither
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setenv("TRIPLED_TENSORBOARD", "1")
    logger = MetricLogger(str(tmp_path))
    logger.log(1, {"loss": 0.5, "name": "not a number"}, prefix="train/")
    logger.log(2, {"loss": 0.25}, prefix="train/")
    logger.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert acc.Tags()["scalars"] == ["train/loss"]
    assert [(e.step, e.value) for e in acc.Scalars("train/loss")] == [(1, 0.5), (2, 0.25)]
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["train/loss"] for r in rows] == [0.5, 0.25]


def test_no_mirror_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("TRIPLED_TENSORBOARD", raising=False)
    MetricLogger(str(tmp_path)).close()
    assert not (tmp_path / "tb").exists()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")) as prof:
        torch.nn.functional.conv2d(torch.rand(1, 3, 16, 16), torch.rand(4, 3, 3, 3)).sum()
    assert prof is not None
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def test_extract_match_matches_jax():
    pytest.importorskip("cv2", reason="cv2 is the optional ORB dependency")
    rng = np.random.RandomState(0)
    base = (rng.rand(120, 160) * 255).astype(np.uint8)
    base = np.kron(base[::4, ::4], np.ones((4, 4), np.uint8))  # blocky: corners to match
    shifted = np.roll(base, (3, 5), axis=(0, 1))
    got = extract_match(base, shifted, 20)
    want = jax_extract_match(base, shifted, 20)
    assert len(got[0]) > 0
    assert got == want
