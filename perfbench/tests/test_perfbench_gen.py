"""The seeded generators: the same seed gives the same bytes, the widths
are the configurations', and the text round-trips to the rows."""

import numpy as np
import pytest
import torch

from perfbench.gen import criteo, higgs
from perfbench.lib import bench

SEEDS = (0, 7, 2 ** 31 + 11, -3)
CONFIG = bench.config("criteo-fm")


def rows_of(n, seed, num_ids=1_000_000):
    """``n`` rows of the criteo-fm configuration's fields."""
    return criteo.criteo_rows(n, seed, CONFIG["field_values"], num_ids,
                              CONFIG["published_rows"], CONFIG["rare_below"])


def parse_text(data: bytes, fields_in_text: bool):
    """A plain parse of libfm / libsvm lines: (labels, ids, values,
    fields)."""
    labels, ids, values, fields = [], [], [], []
    for line in data.decode().splitlines():
        words = line.split(" ")
        labels.append(float(words[0]))
        row_ids, row_values, row_fields = [], [], []
        for token in words[1:]:
            parts = token.split(":")
            if fields_in_text:
                row_fields.append(int(parts[0]))
                parts = parts[1:]
            row_ids.append(int(parts[0]))
            row_values.append(np.float32(float(parts[1])))
        ids.append(row_ids)
        values.append(row_values)
        fields.append(row_fields)
    return (np.asarray(labels, np.float32), np.asarray(ids),
            np.asarray(values, np.float32), np.asarray(fields))


@pytest.mark.parametrize("seed", SEEDS)
def test_criteo_same_seed_same_bytes(seed):
    a = rows_of(3000, seed, num_ids=50_000)
    b = rows_of(3000, seed, num_ids=50_000)
    for fields_in_text in (True, False):
        assert criteo.text_bytes(a, fields_in_text=fields_in_text) == \
            criteo.text_bytes(b, fields_in_text=fields_in_text)
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.labels, b.labels)


def test_criteo_seeds_differ():
    a = rows_of(2000, 1)
    b = rows_of(2000, 2)
    assert not np.array_equal(a.ids, b.ids)


def test_criteo_widths_and_skew():
    rows = rows_of(1 << 17, 5)
    assert rows.ids.shape == (1 << 17, 39) and rows.ids.dtype == np.int32
    assert rows.values.shape == (1 << 17, 39)
    assert rows.ids.min() >= 1 and rows.ids.max() <= 1_000_000
    # each field in a range of its own, in field order: sorted, distinct
    assert np.all(np.diff(rows.ids, axis=1) > 0)
    assert set(np.unique(rows.labels)) <= {0.0, 1.0}
    assert 0.2 < rows.labels.mean() < 0.8
    assert np.array_equal(rows.values,
                          (rows.value_k / 10000.0).astype(np.float32))
    assert rows.value_k.min() >= 0 and rows.value_k.max() < 10000
    # no id takes a large share of all entries: the commonest value of
    # the 4-value field has log(2) / log(5) of its entries, 1.1 % of all
    share = np.bincount(rows.ids.ravel()).max() / rows.ids.size
    assert 0.008 < share < 0.015
    # a field takes no more ids than it has values
    for j, c in enumerate(CONFIG["field_values"]):
        assert np.unique(rows.ids[:, j]).size <= c


def test_field_ranges_fold_rare_values_and_fill_the_ids():
    c = tuple(CONFIG["field_values"])
    values, starts, sizes = criteo.field_ranges(
        c, 1_000_000, CONFIG["published_rows"], CONFIG["rare_below"])
    assert sizes.sum() <= 1_000_000 and sizes.sum() > 999_000
    assert np.array_equal(starts[1:], np.cumsum(sizes)[:-1])
    assert np.all((1 <= sizes) & (sizes <= values) & (values <= c))
    # the 10,131,227 values of C3: those expected 10 times or more in the
    # published rows, and one token for the rest
    big = c.index(10131227)
    assert 250_000 < values[big] < 320_000
    assert values[c.index(3)] == 3  # small fields keep every value
    # the power law: the rank r comes out with chance log((r+2)/(r+1)) /
    # log(c+1), so rank 0 of a 3-value field half the time
    rows = rows_of(1 << 15, 6)
    small = rows.ids[:, c.index(3)]
    assert abs((small == small.min()).mean() - 0.5) < 0.02


def test_field_ranges_fit_few_ids():
    values, starts, sizes = criteo.field_ranges(
        tuple(CONFIG["field_values"]), 1000, CONFIG["published_rows"],
        CONFIG["rare_below"])
    assert sizes.sum() <= 1000 and np.all(sizes >= 1)
    rows = rows_of(4000, 2, num_ids=1000)
    assert rows.ids.max() <= 1000
    assert np.all(np.diff(rows.ids, axis=1) > 0)


@pytest.mark.parametrize("fields_in_text", (True, False))
def test_text_round_trips(fields_in_text):
    rows = rows_of(500, 99)
    rows.value_k[0, :3] = (0, 9999, 10)  # the ends and a leading zero
    rows.values[:] = (rows.value_k / 10000.0).astype(np.float32)
    labels, ids, values, fields = parse_text(
        criteo.text_bytes(rows, fields_in_text=fields_in_text),
        fields_in_text)
    assert np.array_equal(labels, rows.labels)
    assert np.array_equal(ids, rows.ids)
    assert np.array_equal(values.view(np.uint32),
                          rows.values.view(np.uint32))
    if fields_in_text:
        assert np.array_equal(fields, np.broadcast_to(np.arange(39),
                                                      (500, 39)))


def test_text_blocks_join_to_the_whole(tmp_path):
    rows = rows_of(criteo.BLOCK_ROWS + 300, 3, num_ids=20_000)
    path = tmp_path / "rows.libfm"
    size = criteo.write_text(str(path), rows, threads=3)
    data = path.read_bytes()
    assert size == len(data) == len(criteo.text_bytes(rows))
    assert data == criteo.text_bytes(rows)
    assert data.count(b"\n") == rows.num_rows


def test_batch_stats_counts_entries_and_distinct_ids():
    rows = rows_of(100, 4, num_ids=1000)
    got = criteo.batch_stats(rows, 64)
    assert got.shape == (2, 2)
    assert got[0, 0] == 64 * 39 and got[1, 0] == 36 * 39
    assert got[0, 1] == np.unique(rows.ids[:64]).size


@pytest.mark.parametrize("seed", SEEDS)
def test_higgs_same_seed_same_rows(seed):
    x1, y1 = higgs.higgs_rows(5000, 28, seed, "cpu")
    x2, y2 = higgs.higgs_rows(5000, 28, seed, "cpu")
    assert torch.equal(x1, x2) and torch.equal(y1, y2)


def test_higgs_widths_and_labels():
    x, y = higgs.higgs_rows(20000, 28, 8, "cpu")
    assert x.shape == (20000, 28) and x.dtype == torch.float32
    assert y.shape == (20000,)
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    assert 0.1 < float(y.mean()) < 0.9
    assert abs(float(x.std()) - 1.0) < 0.02


def test_higgs_seeds_reorder_the_same_rows():
    x, y = higgs.higgs_rows(20000, 28, 8, "cpu", data_seed=280)
    x3, y3 = higgs.higgs_rows(20000, 28, 9, "cpu", data_seed=280)
    assert not torch.equal(x, x3)
    def rows(a, b):
        order = np.lexsort(a.numpy().T[::-1])
        return a.numpy()[order], b.numpy()[order]

    (a, b), (a3, b3) = rows(x, y), rows(x3, y3)
    assert np.array_equal(a, a3) and np.array_equal(b, b3)
    x4, _ = higgs.higgs_rows(20000, 28, 8, "cpu", data_seed=281)
    assert not torch.equal(torch.sort(x[:, 0]).values,
                           torch.sort(x4[:, 0]).values)
