"""tehmm-view on the port: print a trained model's parameters
(reference: teHmmView.py; SURVEY.md §2b).

Counterpart of ``tehmm_tpu/cli/view.py``.  The model is loaded onto
``--device`` (``cuda`` unless ``--device cpu`` is given) and its
parameters are read back to the host, so the text is the JAX tool's
character for character.  ``--plot`` draws through ``analysis``.

Usage:
  python -m tehmm_tpu_torch.cli.view model.npz [--trans] [--em] [--start] \\
      [--plot PREFIX] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tehmm_tpu_torch.models.hmm import MultitrackHmm
from tehmm_tpu_torch.utils.device import resolve_device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tehmm-view (torch)", description="Print model parameters"
    )
    p.add_argument("inputModel")
    p.add_argument("--trans", action="store_true",
                   help="only the transition matrix")
    p.add_argument("--em", action="store_true",
                   help="only the emission tables")
    p.add_argument("--start", action="store_true",
                   help="only the start distribution")
    p.add_argument("--precision", type=int, default=4)
    p.add_argument("--plot", default=None, metavar="PREFIX",
                   help="write PREFIX.em.png (clustered emission "
                        "heatmap), PREFIX.trans.png and PREFIX.pca.png "
                        "(reference: teHmmView/parameterAnalysis "
                        "graphics)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def _host(t) -> np.ndarray:
    """A parameter tensor read back to the host, in its own dtype."""
    return t.detach().cpu().numpy()


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    device = resolve_device(opts.device)
    try:
        model = MultitrackHmm.load(opts.inputModel, device)
    except FileNotFoundError:
        raise SystemExit(
            f"model file not found: {opts.inputModel}"
        )
    np.set_printoptions(precision=opts.precision, suppress=True)
    show_all = not (opts.trans or opts.em or opts.start)

    names = model.state_names
    print(f"states ({model.num_states}): {' '.join(names)}")
    print(f"tracks ({len(model.track_list)}): "
          f"{' '.join(t.name for t in model.track_list)}")

    if show_all or opts.start:
        print("\nstart probabilities:")
        start = np.exp(_host(model.params.log_start))
        for n, v in zip(names, start):
            print(f"  {n}\t{v:.{opts.precision}f}")

    if show_all or opts.trans:
        print("\ntransition matrix (row = from):")
        trans = np.exp(_host(model.params.log_trans))
        header = "\t".join(names)
        print(f"  \t{header}")
        for n, row in zip(names, trans):
            cells = "\t".join(f"{v:.{opts.precision}f}" for v in row)
            print(f"  {n}\t{cells}")

    if show_all or opts.em:
        print("\nemission tables:")
        log_em = _host(model.params.log_em)
        gauss_cols = {
            t.name: g for g, t in enumerate(
                t2 for t2 in model.track_list
                if t2.distribution == "gaussian"
            )
        }
        for t in model.track_list:
            if t.distribution == "gaussian":
                # per-state normal emissions (models/gauss.py)
                print(f"  track {t.name} (gaussian):")
                g = gauss_cols[t.name]
                mu = _host(model.gauss.mu)
                sd = np.exp(0.5 * _host(model.gauss.log_var))
                for s_idx, s_name in enumerate(names):
                    print(
                        f"    {s_name}\t"
                        f"mean={mu[s_idx, g]:.{opts.precision}f} "
                        f"sd={sd[s_idx, g]:.{opts.precision}f}"
                    )
                continue
            cm = model.category_maps[t.name]
            print(f"  track {t.name}:")
            syms = [
                (v, cm.get_back_map(v)) for v in range(1, len(cm))
            ]
            for s_idx, s_name in enumerate(names):
                parts = [
                    f"{val}={np.exp(log_em[s_idx, t.number, v]):.{opts.precision}f}"
                    for v, val in syms
                ]
                print(f"    {s_name}\t" + " ".join(parts))

    cfg_meta = (model.extra or {}).get("cfg")
    if show_all and cfg_meta:
        # pair-grammar decoration (reference: teHmmView prints the whole
        # model; cfg pair weights are part of it)
        print("\ncfg pair grammar:")
        pair = cfg_meta.get("pair_states", [])
        print(f"  pair states: {' '.join(pair) if pair else '(none)'}")
        print(f"  max span: {cfg_meta.get('max_span')}")
        if "sa_prior" in cfg_meta:
            print(f"  self-alignment prior: {cfg_meta['sa_prior']}")
        if "log_match" in cfg_meta:
            lm = cfg_meta["log_match"]
            for n in pair:
                i = names.index(n)
                print(f"  log_match[{n}] = "
                      f"{lm[i]:.{opts.precision}f}")
        elif "match_bonus" in cfg_meta:
            print(f"  match bonus (shared): "
                  f"{cfg_meta['match_bonus']:.{opts.precision}f}")

    if opts.plot:
        from tehmm_tpu_torch import analysis

        log_em = _host(model.params.log_em)
        track_names = [t.name for t in model.track_list]
        analysis.plot_emission_heatmap(
            log_em, names, track_names, f"{opts.plot}.em.png"
        )
        analysis.plot_transition_graph(
            _host(model.params.log_trans), names,
            f"{opts.plot}.trans.png",
        )
        analysis.plot_state_pca(log_em, names, f"{opts.plot}.pca.png")
        print(f"wrote {opts.plot}.{{em,trans,pca}}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
