"""The benchmark's counts of operations and bytes against hand counts."""

import json

import numpy as np

from conftest import ROOT
from gpubench import work
from gpubench.kinds.dlrm import work as dlrm_work
from gpubench.kinds.two_tower import work as tt_work

TT = json.loads((ROOT / "gpubench/configs/two_tower_ml25m.json").read_text())
DLRM = json.loads((ROOT / "gpubench/configs/dlrm_criteo_tb.json").read_text())


def test_two_tower_train_flops():
    B, D = 8192, 128
    # query: (userId 128 + userId_count 1) -> 256 -> 128; item: (TE 1 + genres 128
    # + movieId 128) -> 256 -> 128
    towers = 2 * B * (129 * 256 + 256 * 128) + 2 * B * (257 * 256 + 256 * 128)
    loss = 3 * 2 * B * B * D
    assert tt_work.train_flops(TT, B) == 3 * towers + loss
    assert tt_work.loss_flops(TT, B) == loss == 51_539_607_552
    assert tt_work.query_flops(TT, B) == 2 * B * (129 * 256 + 256 * 128)


def test_two_tower_loss_bytes():
    B, D = 8192, 128
    assert tt_work.loss_bytes(TT, B) == 4 * (4 * B * D + 4 * B)


def test_dlrm_train_flops():
    B, D, F = 8192, 64, 27
    bottom = 13 * 512 + 512 * 256 + 256 * 64
    top = (64 + 27 * 26 // 2) * 512 + 512 * 512 + 512 * 256 + 256 * 1
    forward = 2 * B * (bottom + top) + 2 * B * F * F * D
    assert dlrm_work.train_flops(DLRM, B) == 3 * forward
    assert dlrm_work.dense_params(DLRM) == bottom + 512 + 256 + 64 + top + 512 + 512 + 256 + 1


def test_adagrad_bytes_count_touched_rows_only():
    data = {f"C{i}": np.array([1, 1, 2, 3], dtype=np.int32) for i in range(1, 27)}
    rows = np.arange(4)
    touched = 26 * 3
    assert dlrm_work.optimizer_bytes(DLRM, data, rows) == 5 * 4 * (
        touched * 64 + dlrm_work.dense_params(DLRM))


def test_two_tower_optimizer_bytes_count_list_values():
    data = {"movieId": np.array([5, 5], dtype=np.int32),
            "userId": np.array([1, 2], dtype=np.int32),
            "genres__values": np.array([3, 4, 3], dtype=np.int32),
            "genres__offsets": np.array([0, 2, 3], dtype=np.int64)}
    expect = 5 * 4 * ((1 + 2 + 2) * 128 + tt_work.dense_params(TT))
    assert tt_work.optimizer_bytes(TT, data, np.arange(2)) == expect


def test_topk_counts():
    assert work.topk_flops(8192, 56681, 128) == 2 * 8192 * 56681 * 128
    assert work.topk_bytes(8192, 56681, 128, 10) == 4 * (56681 * 128 + 8192 * 128) + 8192 * 80
