#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the run exits non-zero):

1. Device and build: the card's name and power limit, and the build of
   the CUDA kernels from ``tehmm_tpu_torch/csrc/viterbi.cu``.
2. Each kernel against its plain-torch version on the card, at the
   decode's shapes (S=10 states, T=5 tracks, V=9 symbols, B=512 rows of
   L=4608 = chunk 4096 + 2 x 256 halo, ragged lengths incl. 0 and 1):
   value rows, normalizers, carries and paths bit-equal; times of both.
3. End to end through the port's CLIs, in-process, at the width of the
   10-state / 5-track supervised decode configuration: a planted
   20,000,000-position chromosome (4 categorical BED tracks + FASTA),
   ``train --supervised`` then stitched ``eval --bed`` on the whole
   chromosome; the BED tiles it, every stitch boundary agrees, and base
   accuracy against the planted truth is >= 0.9.  On a 1,000,000-position
   region ``--exact`` and ``--no-exact`` write the same BED, and on a
   20,000-position region the card's BED equals the CPU's (plain torch).
4. The launch counters, zeroed before phase 3, show every kernel ran on
   the main path.

The last lines are a JSON object of per-kernel results, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Without CUDA it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

S, T, V = 10, 5, 9                   # states, tracks, symbols (+missing)
B_ROWS, L_ROWS = 512, 4096 + 2 * 256  # one decode group
GC = np.linspace(0.3, 0.7, S)        # per-state GC content
N_CATS, BLOCK = 8, 50                # BED categories, bases per record
RUN_MEAN = 2000                      # mean planted run length
SOURCE = "tehmm_tpu_torch/csrc/viterbi.cu"
REPLACES = {
    "viterbi_fwd": "tehmm_tpu/ops/pallas_kernels.py:2386",
    "viterbi_backtrace": "tehmm_tpu/ops/pallas_kernels.py:2517",
    "viterbi_chunk_values": "tehmm_tpu/ops/pallas_kernels.py:1284",
}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _median_ms(fn, runs: int) -> float:
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def phase_kernels(device, rng) -> dict:
    import torch

    from tehmm_tpu_torch.models.emission import track_log_likelihoods
    from tehmm_tpu_torch.models.params import from_numpy
    from tehmm_tpu_torch.ops import cuda_kernels as ck
    from tehmm_tpu_torch.ops import dp

    trans = rng.dirichlet(np.ones(S), size=S) * 0.05 + np.eye(S) * 0.95
    log_em = np.zeros((S, T, V))
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    p = from_numpy(np.log(np.full(S, 1.0 / S)), np.log(trans), log_em,
                   device)
    lengths = rng.randint(0, L_ROWS + 1, size=B_ROWS).astype(np.int32)
    lengths[:4] = [L_ROWS, 0, 1, 2]
    sym = torch.from_numpy(
        rng.randint(0, V, size=(B_ROWS, L_ROWS, T)).astype(np.int32)
    ).to(device)
    lens = torch.from_numpy(lengths).to(device)
    fwd_args = (p.log_start, p.log_trans, p.log_em, sym, lens)
    out = {}

    # K2 forward
    v, dm = ck.viterbi_fwd(*fwd_args)
    pv, pdm = ck.viterbi_fwd_plain(*fwd_args)
    assert torch.equal(v, pv) and torch.equal(dm, pdm), \
        "viterbi_fwd disagrees with its plain version"
    out["viterbi_fwd"] = dict(
        max_abs_err=float(max((v - pv).abs().max(), (dm - pdm).abs().max())),
        ms=_median_ms(lambda: ck.viterbi_fwd(*fwd_args), 5),
        plain_ms=_median_ms(lambda: ck.viterbi_fwd_plain(*fwd_args), 3),
    )

    # K2 backtrace, on the forward's rows as viterbi_fused calls it
    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    body_lens = torch.clamp(lens - 1, min=0)
    rows, entry = v[:, 1:], v[:, 0]
    bt_args = (p.log_trans, rows, entry, end, body_lens)
    plain_args = (p.log_trans, rows.contiguous(), entry.contiguous(), end,
                  body_lens)
    got = ck.viterbi_backtrace(*bt_args)
    want = ck.viterbi_backtrace_plain(*plain_args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        "viterbi_backtrace disagrees with its plain version"
    out["viterbi_backtrace"] = dict(
        max_abs_err=float((got[0] - want[0]).abs().max()),
        ms=_median_ms(lambda: ck.viterbi_backtrace(*bt_args), 5),
        plain_ms=_median_ms(
            lambda: ck.viterbi_backtrace_plain(*plain_args), 3),
    )

    # K2 as a whole against dp.viterbi on the plain obs
    path, score = ck.viterbi_fused(*fwd_args)
    obs = track_log_likelihoods(p.log_em, sym)
    want_p, want_s = dp.viterbi(p.log_start, p.log_trans, obs, lens)
    assert torch.equal(path, want_p), "viterbi_fused path != dp.viterbi"
    # tree-order sum of the normalizers vs dp.viterbi's sequential one
    rel = float(((score - want_s).abs()
                 / want_s.abs().clamp(min=1.0)).max())
    assert rel < 1e-5, f"viterbi_fused score rel err {rel}"
    print(f"[kernels] fused decode: paths == dp.viterbi, score rel err "
          f"{rel:.3g}", flush=True)

    # K3, both modes
    init = torch.from_numpy(
        rng.randn(B_ROWS, S).astype(np.float32)).to(device)
    k3_args = (p.log_trans, obs, init, lens)
    got = ck.viterbi_chunk_values(*k3_args)
    want = dp.viterbi_chunk_values(*k3_args)
    carry, want_c = ck.viterbi_carry(*k3_args), dp.viterbi_carry(*k3_args)
    assert torch.equal(got, want) and torch.equal(carry, want_c), \
        "viterbi_chunk_values disagrees with its plain version"
    out["viterbi_chunk_values"] = dict(
        max_abs_err=float(max((got - want).abs().max(),
                              (carry - want_c).abs().max())),
        ms=_median_ms(lambda: ck.viterbi_chunk_values(*k3_args), 5),
        plain_ms=_median_ms(lambda: dp.viterbi_chunk_values(*k3_args), 3),
    )
    for name, r in out.items():
        print(f"[kernels] {name:22s} bit-equal  kernel {r['ms']:10.3f} ms"
              f"  plain {r['plain_ms']:10.3f} ms", flush=True)
    return out


# ---------------------------------------------------------------------
# phase 3: end to end through the CLIs
# ---------------------------------------------------------------------

def _planted_runs(rng, n):
    """Sticky planted path as runs: (states, starts, lengths)."""
    k = int(n / RUN_MEAN * 2) + 16
    lens = rng.geometric(1.0 / RUN_MEAN, size=k).astype(np.int64)
    states = rng.randint(0, S, size=k)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, n)) + 1
    lens, states = lens[:k], states[:k]
    lens[-1] -= int(ends[k - 1]) - n
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return states, starts, lens


def _write_lines(path, chrom, starts, ends, names):
    with open(path, "w") as fh:
        fh.write("".join(
            f"{chrom}\t{s}\t{e}\t{v}\n"
            for s, e, v in zip(starts.tolist(), ends.tolist(), names)
        ))


def make_dataset(work, rng, n):
    """Planted truth + tracks on disk; returns (xml, truth_bed, truth)."""
    states, starts, lens = _planted_runs(rng, n)
    truth = np.repeat(states, lens).astype(np.int8)
    _write_lines(os.path.join(work, "truth.bed"), "chr1", starts,
                 starts + lens, [f"S{s}" for s in states.tolist()])
    # categorical BED tracks: one record per BLOCK bases, its category
    # drawn from a per-track, per-state distribution (state at the
    # record's first base)
    bstart = np.arange(0, n, BLOCK, dtype=np.int64)
    bend = np.minimum(bstart + BLOCK, n)
    xml = []
    for k in range(T - 1):
        probs = rng.dirichlet(np.full(N_CATS, 0.1), size=S)
        cum = probs[truth[bstart]].cumsum(axis=1)
        cats = (cum < rng.rand(len(bstart), 1)).sum(axis=1) \
            .clip(0, N_CATS - 1)
        _write_lines(os.path.join(work, f"bed{k}.bed"), "chr1", bstart,
                     bend, [f"c{c}" for c in cats.tolist()])
        xml.append(f'  <track name="bed{k}" path="bed{k}.bed"/>')
    # FASTA whose GC content follows the planted state
    gc = rng.random_sample(n) < GC[truth]
    coin = rng.randint(0, 2, size=n).astype(bool)
    bases = np.where(gc, np.where(coin, ord("G"), ord("C")),
                     np.where(coin, ord("A"), ord("T"))).astype(np.uint8)
    width = 80
    with open(os.path.join(work, "genome.fa"), "wb") as fh:
        fh.write(b">chr1\n")
        step = width << 16                # whole lines per write
        for lo in range(0, n, step):
            blk = bases[lo : lo + step]
            full = len(blk) // width * width
            lines = np.concatenate(
                [blk[:full].reshape(-1, width),
                 np.full((full // width, 1), ord("\n"), np.uint8)], axis=1,
            ).tobytes()
            fh.write(lines)
            if full < len(blk):
                fh.write(blk[full:].tobytes() + b"\n")
    xml.append('  <track name="seq" path="genome.fa"/>')
    xml_path = os.path.join(work, "tracks.xml")
    with open(xml_path, "w") as fh:
        fh.write("<teModelConfig>\n" + "\n".join(xml)
                 + "\n</teModelConfig>\n")
    return xml_path, os.path.join(work, "truth.bed"), truth


class _Stages:
    """Wall time of the calls the CLIs make into each layer, recorded by
    wrapping those calls for the duration of a run."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.last: dict[str, object] = {}
        self._undo = []

    def wrap(self, owner, attr, stage):
        fn = getattr(owner, attr)
        original = vars(owner)[attr]      # e.g. the classmethod itself

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            self.seconds[stage] = self.seconds.get(stage, 0.0) \
                + time.perf_counter() - t0
            self.last[stage] = result
            return result

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, original))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def _run_cli(cli, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, f"{cli.__name__} exited {rc}"
    return buf.getvalue().strip()


def _paint(bed_path, n, names):
    from tehmm_tpu.io import read_bed_intervals

    out = np.full(n, -1, np.int16)
    prev_end = 0
    for chrom, s, e, name in read_bed_intervals(bed_path, ncol=4):
        assert chrom == "chr1" and s == prev_end and e > s, \
            f"BED does not tile the chromosome at {s}"
        out[s:e] = names.index(name)
        prev_end = e
    assert prev_end == n, f"BED ends at {prev_end}, not {n}"
    return out


def phase_end_to_end(work, rng, n, region, small, device="cuda"):
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train
    from tehmm_tpu_torch.models.hmm import MultitrackHmm

    t0 = time.perf_counter()
    xml, truth_bed, truth = make_dataset(work, rng, n)
    print(f"[e2e] dataset: {n} positions, {T} tracks, "
          f"{time.perf_counter() - t0:.1f} s to write", flush=True)
    regions = os.path.join(work, "regions.bed")
    with open(regions, "w") as fh:
        fh.write(f"chr1\t0\t{n}\n")
    model = os.path.join(work, "model.npz")
    out_bed = os.path.join(work, "decoded.bed")

    stages = _Stages()
    stages.wrap(port_train, "load_track_data", "train: load")
    stages.wrap(MultitrackHmm, "supervised", "train: count + M-step")
    stages.wrap(MultitrackHmm, "save", "train: save")
    stages.wrap(port_eval, "load_track_data", "eval: load")
    stages.wrap(MultitrackHmm, "decode_tables", "eval: decode")
    stages.wrap(port_eval, "path_log_score", "eval: path score")
    stages.wrap(port_eval, "write_bed_intervals", "eval: write")
    try:
        t0 = time.perf_counter()
        _run_cli(port_train, [xml, truth_bed, model, "--supervised",
                              "--device", device])
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = _run_cli(port_eval, [xml, model, regions, "--bed", out_bed,
                                     "--device", device])
        t_eval = time.perf_counter() - t0
    finally:
        stages.restore()
    paths, report = stages.last["eval: decode"]
    assert report.boundaries_ok, report
    print(f"[e2e] eval printed path score {score}; {report}", flush=True)
    assert np.isfinite(float(score))

    names = MultitrackHmm.load(model, "cpu").state_names
    decoded = _paint(out_bed, n, names)
    name_idx = np.asarray([int(s[1:]) for s in names])
    acc = float((name_idx[decoded] == truth).mean())
    print(f"[e2e] base accuracy vs planted truth: {acc:.6f}", flush=True)
    assert acc >= 0.9, f"base accuracy {acc} < 0.9"

    # exact (K3 + backtrace) and stitched (K2) agree on a region
    lo = n // 4
    region_bed = os.path.join(work, "region.bed")
    with open(region_bed, "w") as fh:
        fh.write(f"chr1\t{lo}\t{lo + region}\n")
    beds = {}
    for flag in ("--exact", "--no-exact"):
        out = os.path.join(work, f"region{flag}.bed")
        t0 = time.perf_counter()
        _run_cli(port_eval, [xml, model, region_bed, "--bed", out,
                             "--device", device, flag])
        print(f"[e2e] {region}-position region {flag}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        beds[flag] = open(out).read()
    assert beds["--exact"] == beds["--no-exact"], \
        "--exact and --no-exact BED differ"

    # the card against the CPU's plain torch on a small region
    small_bed = os.path.join(work, "small.bed")
    with open(small_bed, "w") as fh:
        fh.write(f"chr1\t{lo}\t{lo + small}\n")
    small_out = {}
    for dev in (device, "cpu"):
        out = os.path.join(work, f"small_{dev}.bed")
        _run_cli(port_eval, [xml, model, small_bed, "--bed", out,
                             "--device", dev])
        small_out[dev] = open(out).read()
    assert small_out[device] == small_out["cpu"], \
        "card and CPU BED differ on the small region"
    print(f"[e2e] {small}-position region: card BED == CPU BED",
          flush=True)

    print("[e2e] stage                    seconds", flush=True)
    for stage, sec in stages.seconds.items():
        print(f"[e2e] {stage:24s} {sec:9.3f}", flush=True)
    print(f"[e2e] {'train CLI total':24s} {t_train:9.3f}", flush=True)
    print(f"[e2e] {'eval CLI total':24s} {t_eval:9.3f}", flush=True)
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tehmm_tpu_torch.ops import cuda_kernels as ck

    device = torch.device("cuda")
    smi = _smi()
    print(f"[device] {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    ck.load_library()
    print(f"[build] {SOURCE}: {time.perf_counter() - t0:.2f} s "
          f"-> {ck.library_path()}", flush=True)

    rng = np.random.RandomState(args.seed)
    kernels = phase_kernels(device, rng)

    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="tehmm_chip_smoke_") as work:
        phase_end_to_end(work, rng, 20_000_000, 1_000_000, 20_000)
    launches = dict(ck.LAUNCHES)
    print(f"[e2e] peak device memory allocated: "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB", flush=True)
    print(f"[launches] main path: {launches}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    assert not any(m.split(".")[0] in ("jax", "jaxlib")
                   for m in sys.modules), "jax was imported"

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=launches[name], **r)
        for name, r in kernels.items()
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
