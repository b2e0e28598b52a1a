"""chip_smoke.py's phases at tiny sizes on the CPU: the same code paths and
oracles the on-device run uses, and the refusal to run without a GPU."""

import json
import os

import numpy as np
import pytest

import chip_smoke as cs
from kmerutils_tpu.base import kmer as kmer_mod


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    wd = tmp_path_factory.mktemp("smoke")
    flat, lens = cs.make_reads(1, genome_len=30_000, coverage=4)
    fq = str(wd / "reads.fastq")
    cs.write_fastq(fq, flat, lens)
    return str(wd), fq, flat, lens


@pytest.mark.parametrize("wide,coords", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_fold_aggregate_vs_numpy(wide, coords):
    rng = np.random.default_rng(5)
    m, n_live = cs.check_fold_aggregate(rng, 1 << 12, 512, wide, coords)
    assert m == (1 << 12) // 4 + 512 - 512 // 64
    assert n_live > 0


def test_fold_past_capacity_vs_numpy():
    # a batch larger than the free room: the largest keys drop, the rest
    # still equals numpy's stable merge
    rng = np.random.default_rng(6)
    m, _ = cs.check_fold_aggregate(rng, 1 << 10, 1024, False, False)
    assert m == 1 << 10


def test_make_reads_matches_spec():
    flat, lens = cs.make_reads(3, genome_len=50_000, coverage=5)
    assert flat.dtype == np.uint8 and flat.max() <= 3
    assert int(lens.sum()) == flat.size >= 50_000 * 5
    assert lens.min() >= 500 and lens.max() <= 16_000
    assert 2_000 < np.median(lens) < 12_000


def test_canonical_oracle_matches_kmer_module():
    flat, lens = cs.make_reads(4, genome_len=5_000, coverage=1)
    can, read, pos = cs.canonical_oracle(flat, lens, 11)
    offs = np.concatenate([[0], np.cumsum(lens)])
    comp = str.maketrans("ACGT", "TGCA")
    for i in np.random.default_rng(0).choice(can.size, 200, replace=False):
        s = "".join("ACGT"[c] for c in
                    flat[offs[read[i]] + pos[i]:offs[read[i]] + pos[i] + 11])
        want = min(kmer_mod.kmer_value_from_str(s),
                   kmer_mod.kmer_value_from_str(s.translate(comp)[::-1]))
        assert int(can[i]) == want
    assert can.size == int((lens - 10).sum())


@pytest.mark.parametrize("k", [16, 31])
def test_count_cli_vs_oracle(reads, k):
    wd, fq, flat, lens = reads
    n_kmers, n_distinct, n_rec, dt = cs.check_count(fq, flat, lens, k, wd)
    assert n_kmers == int((lens - k + 1).sum())
    assert 0 < n_rec < n_distinct and dt > 0


def test_unique_cli_vs_oracle(reads):
    wd, _, flat, lens = reads
    sf, sl = cs.slice_reads(flat, lens, 40_000)
    fq = os.path.join(wd, "slice.fastq")
    cs.write_fastq(fq, sf, sl)
    n_once, _ = cs.check_unique(fq, sf, sl, wd)
    assert n_once > 0


def test_sketch_cli_vs_cpu(reads):
    wd, fq, flat, lens = reads
    share, _ = cs.check_sketch(fq, flat, lens, wd, 8, 0)
    assert share == 1.0          # CPU against CPU: bit-identical


def test_sketch_memory_analysis_reports():
    assert "temp" in cs.sketch_memory(4, 512)


def test_four_card_phase_on_cpu_mesh(reads):
    _, fq, _, _ = reads
    out = cs.phase_four_cards(fq, n_dev=4, cap_per_device=1 << 16)
    assert set(out) == {16, 31} and min(out.values()) > 0


def test_check_raises_smoke_failure():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")


def test_main_refuses_cpu(capsys, tmp_path):
    assert cs.main(["--workdir", str(tmp_path / "w")]) != 0
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.strip().splitlines()[-1] if out.strip() else "")
