"""The port's data layer and configuration (data/annotation.py,
data/encoders.py, data/splits.py, data/csi_io.py, metrics/
classification.py, utils/results.py, core/config.py) against the JAX
package's, which lean on pandas and sklearn, on the CPU.

Everything here is discrete or copied bit for bit, so every comparison is
exact, except the classification report's floats, which are held to
1e-12 relative (sums of per-label scores in another order).
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
from sklearn.metrics import accuracy_score as sk_accuracy
from sklearn.metrics import classification_report as sk_report

from multi_modal_csi_tpu.core import config as jax_config
from multi_modal_csi_tpu.data import annotation as jax_annotation
from multi_modal_csi_tpu.data import csi_io as jax_csi_io
from multi_modal_csi_tpu.data import encoders as jax_encoders
from multi_modal_csi_tpu.data import splits as jax_splits
from multi_modal_csi_tpu.utils.results import (
    NumpyJSONEncoder as JaxJSONEncoder)
from multi_modal_csi_tpu_torch.core import config
from multi_modal_csi_tpu_torch.data import annotation, csi_io, encoders, splits
from multi_modal_csi_tpu_torch.metrics.classification import (
    accuracy_score, classification_report)
from multi_modal_csi_tpu_torch.utils.results import NumpyJSONEncoder

ACTIVITIES = ["nothing", "walk", "rotation", "jump", "wave", "lie_down",
              "pick_up", "sit_down", "stand_up"]
COLUMNS = (["label", "environment", "wifi_band", "number_of_users"]
           + [f"user_{i}_{what}" for i in range(1, 7)
              for what in ("location", "activity")])


def write_annotation(path, n=40, seed=0):
    """A WiMANS-style annotation.csv: absent users' cells left empty, with
    a few other spellings pandas reads as missing."""
    rng = np.random.default_rng(seed)
    missing = ["", "", "", "NA", "nan"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        for i in range(n):
            users = int(rng.integers(0, 6))
            row = [f"act_{i}_{users}",
                   ["classroom", "meeting_room", "empty_room"][i % 3],
                   ["2.4", "5"][int(rng.integers(0, 2))], str(users)]
            for u in range(6):
                if u < users:
                    row += [str(rng.choice(list("abcde"))),
                            str(rng.choice(ACTIVITIES))]
                else:
                    row += [str(rng.choice(missing))] * 2
            w.writerow(row)


@pytest.fixture
def csv_path(tmp_path):
    path = str(tmp_path / "annotation.csv")
    write_annotation(path)
    return path


FILTERS = [dict(), dict(environment=["classroom"]),
           dict(environment=["empty_room", "classroom"], wifi_band=["5"],
                num_users=["0", "2", "3", "5"]),
           dict(wifi_band=["2.4"], num_users=[])]


@pytest.mark.parametrize("filters", FILTERS)
def test_annotation_filter_labels_and_encoders_match_jax(csv_path, filters):
    mine = annotation.filter_annotation(annotation.load_annotation(csv_path),
                                        **filters)
    theirs = jax_annotation.filter_annotation(
        jax_annotation.load_annotation(csv_path), **filters)
    assert annotation.label_list(mine) == jax_annotation.label_list(theirs)
    for task in ("identity", "activity", "location"):
        got = encoders.encode_labels(mine, task)
        want = jax_encoders.encode_labels(theirs, task)
        assert got.dtype == want.dtype and np.array_equal(got, want), task


def test_unknown_labels_and_tasks_raise(tmp_path):
    path = str(tmp_path / "annotation.csv")
    write_annotation(path, n=3)
    rows = list(csv.reader(open(path)))
    rows[1][COLUMNS.index("user_1_activity")] = "dance"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    df = annotation.load_annotation(path)
    with pytest.raises(KeyError, match="dance"):
        encoders.encode_activity(df)
    with pytest.raises(KeyError, match="dance"):
        jax_encoders.encode_activity(jax_annotation.load_annotation(path))
    with pytest.raises(ValueError, match="unknown task"):
        encoders.encode_labels(df, "pose")


@pytest.mark.parametrize("queries", [None, 5, 7])
def test_reduce_dataset_matches_jax(queries):
    """Random one-hots with 0 to 6 active users, and rows with no all-zero
    user (the reference's argmax quirk deletes row 0)."""
    rng = np.random.default_rng(1)
    n = 64
    y = np.zeros((n, 6, 9), np.int64)
    active = rng.integers(0, 7, size=n)
    for i in range(n):
        y[i, :active[i]] = np.eye(9, dtype=np.int64)[
            rng.integers(0, 9, size=active[i])]
    got = encoders.reduce_dataset(y, queries)
    want = jax_encoders.reduce_dataset(y, queries)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("n", [2, 5, 10, 11, 35, 48, 97, 300])
def test_splits_match_sklearn_through_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3, 2)).astype(np.float32)
    y = rng.integers(0, 2, size=(n, 4))
    for got, want in zip(splits.env_split(x, y), jax_splits.env_split(x, y)):
        assert np.array_equal(got, want)
    for got, want in zip(splits.valid_test_split(x, y),
                         jax_splits.valid_test_split(x, y)):
        assert np.array_equal(got, want)
    per_env = [splits.env_split(x, y), splits.env_split(x[::-1], y[::-1])]
    for got, want in zip(splits.concat_env_splits(per_env),
                         jax_splits.concat_env_splits(per_env)):
        assert np.array_equal(got, want)


def test_split_of_one_sample_raises():
    with pytest.raises(ValueError, match="empty"):
        splits.valid_test_split(np.zeros((1, 2)), np.zeros((1, 2)))


@pytest.mark.parametrize("shape,p_one", [((40, 54), 0.1), ((25, 10), 0.4),
                                         ((7, 6), 0.0), ((30, 5), 0.9)])
def test_classification_report_matches_sklearn(shape, p_one):
    """Multilabel indicator arrays, with empty labels and empty rows
    (zero_division=0 paths) among them."""
    rng = np.random.default_rng(shape[0])
    y = (rng.random(shape) < max(p_one, 0.05)).astype(int)
    y[:, 0] = 0
    p = (rng.random(shape) < p_one).astype(int)
    want = sk_report(y, p, digits=6, zero_division=0, output_dict=True)
    got = classification_report(y, p)
    assert list(got) == list(want)
    for key in want:
        assert list(got[key]) == list(want[key])
        for metric, value in want[key].items():
            assert got[key][metric] == pytest.approx(value, rel=1e-12,
                                                     abs=1e-15), (key, metric)
    assert accuracy_score(y, p) == sk_accuracy(y, p)
    assert accuracy_score(y, y) == 1.0


def test_load_csi_windows_matches_jax(tmp_path):
    """Left-pad to 3000, keep the LAST 3000 steps of a longer window."""
    rng = np.random.default_rng(2)
    labels = []
    for i, t in enumerate([2500, 3000, 3100, 2999, 1]):
        labels.append(f"act_{i}")
        np.save(tmp_path / f"act_{i}.npy",
                rng.standard_normal((t, 3, 3, 30)).astype(np.float32))
    got = csi_io.load_csi_windows(str(tmp_path), labels, 3000)
    want = jax_csi_io.load_csi_windows(str(tmp_path), labels, 3000)
    assert got.shape == want.shape == (5, 3000, 3, 3, 30)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(csi_io.flatten_features(got),
                          jax_csi_io.flatten_features(want))
    assert csi_io.load_csi_windows(str(tmp_path), [], 3000).shape == (
        0, 3000, 3, 3, 30)


def _same_config(mine, theirs):
    """Every field of the port's Config equals the JAX one's."""
    a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert set(a) <= set(b)
    for key in a:
        assert a[key] == b[key], key
    assert dataclasses.asdict(mine.data) == dataclasses.asdict(theirs.data)
    assert dataclasses.asdict(mine.nn) == dataclasses.asdict(theirs.nn)


def test_config_defaults_and_overrides_match_jax(tmp_path, monkeypatch):
    _same_config(config.Config(), jax_config.Config())
    assert config.ACTIVITY_ENCODING == jax_config.ACTIVITY_ENCODING
    assert config.LOCATION_ENCODING == jax_config.LOCATION_ENCODING

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({
        "model": "THAT_ENCODER", "repeat": 2,
        "nn": {"lr": 1e-3, "scheduler": {"num_warmup_epochs": 3},
               "loss": {"label_smoothing": 0.1}},
        "data": {"environment": ["classroom"], "length": 2000},
        "encoding_location": {"nan": [0, 0], "a": [1, 0], "b": [0, 1]}}))
    env = {"LEARNING_RATE": "2e-4", "BATCH_SIZE": "8", "NUM_QUERIES": "7",
           "DATA_PATH": "/data", "ENVIRONMENTS_EXP": "classroom, empty_room",
           "MODEL_TYPE": "DETR"}
    cli = {"nn.epoch": "3", "data.num_users": "1,2", "save_model": "true",
           "compute_dtype": "auto", "nn.threshold": 1}
    for key in list(os.environ):
        if key in env or key in jax_config._ENV_MAP:
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    mine = config.load_config(str(path), cli)
    _same_config(mine, jax_config.load_config(str(path), cli))
    assert (mine.nn.lr, mine.nn.batch_size, mine.nn.epoch) == (2e-4, 8, 3)
    assert mine.data.environment == ["classroom", "empty_room"]
    assert mine.path.data_y == "/data/annotation.csv" and mine.save_model

    base = config.Config()
    _same_config(config.apply_env_overrides(base, {"NUM_EPOCHS": "4"}),
                 jax_config.apply_env_overrides(jax_config.Config(),
                                                {"NUM_EPOCHS": "4"}))
    assert base.nn.epoch == 300          # the original is left as it was
    with pytest.raises(KeyError, match="unknown config key"):
        base.override({"nn.dropout": 0.2})


def test_numpy_json_encoder_matches_jax():
    value = {"a": np.int64(3), "b": np.float32(0.25), "c": np.arange(3),
             "d": [np.float64(1.5)], "e": np.bool_(True)}
    assert (json.dumps(value, cls=NumpyJSONEncoder)
            == json.dumps(value, cls=JaxJSONEncoder))
