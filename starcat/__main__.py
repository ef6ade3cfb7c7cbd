"""CLI entry point (SURVEY.md ⑳): `python -m starcat <command> ...`.

Commands:
  run       --config cfg2_nuts [key=value ...]   run a preset head
  report    --config ... [--out-prefix P]         run a preset, save plots
                                                  (needs matplotlib)
  validate  [--config cfg0_single_star]          oracle vs JAX moment match
  list                                            list presets

The persistent compile cache goes to JAX_COMPILATION_CACHE_DIR when it is
set, else to .jax_cache/ at the checkout root (runtime.py).
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse_overrides(pairs):
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override must be key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_list(_args):
    from .configs import CONFIGS

    for name, cfg in CONFIGS.items():
        print(f"{name:22s} head={cfg.head:6s} scene={cfg.scene.height}x{cfg.scene.width} "
              f"stars={cfg.n_stars} kmax={cfg.kmax} {cfg.notes}")


def cmd_run(args):
    from .api import sample, summarize_output
    from .configs import CONFIGS, apply_overrides

    if args.config not in CONFIGS:
        raise SystemExit(f"unknown config {args.config!r}; try: {', '.join(CONFIGS)}")
    cfg = apply_overrides(CONFIGS[args.config], _parse_overrides(args.overrides))
    if cfg.head == "oracle":
        cfg = apply_overrides(cfg, {"head": "hmc"})  # oracle preset -> JAX HMC head
    out = sample(cfg, seed=args.seed, metrics_path=args.metrics,
                 checkpoint_path=args.checkpoint, resume=args.resume)
    summ = summarize_output(out)
    record = {
        "config": cfg.name,
        "head": cfg.head,
        "stats": {k: v for k, v in out.stats.items() if k != "truth"},
        "summary": summ,
    }
    print(json.dumps(record, default=float, indent=None))


def cmd_report(args):
    """Run a preset and write trace/corner/reconstruction PNGs (L0 layer)."""
    import importlib.util

    import numpy as np

    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("starcat report needs matplotlib, which is not "
                         "installed; `run` needs nothing beyond JAX")

    from .api import sample, summarize_output
    from .configs import CONFIGS, apply_overrides
    from .plots import save_report

    if args.config not in CONFIGS:
        raise SystemExit(f"unknown config {args.config!r}; try: {', '.join(CONFIGS)}")
    cfg = apply_overrides(CONFIGS[args.config], _parse_overrides(args.overrides))
    if cfg.head == "oracle":
        cfg = apply_overrides(cfg, {"head": "hmc"})
    truth, img = cfg.make_data()
    out = sample(cfg, seed=args.seed, image=img)
    paths = save_report(out, np.asarray(img), args.out_prefix)
    # catalog-level summary (condensed catalog + completeness/purity vs
    # the mock truth, starcat/catalogs.py)
    from .catalogs import catalog_report

    cat = catalog_report(out, truth_theta=truth)
    cat_path = f"{args.out_prefix}_catalog.json"
    with open(cat_path, "w") as fh:
        json.dump(cat, fh, default=float)
    paths.append(cat_path)
    print(json.dumps({"config": cfg.name, "plots": paths,
                      "summary": summarize_output(out),
                      "condensed_sources": cat["n_condensed_ge_half"]},
                     default=float))


def validate(config: str = "cfg0_single_star",
             heads=("hmc", "nuts", "chees", "rhmc", "smc", "advi",
                    "transdim")) -> dict:
    """Oracle validation of every head (SURVEY.md §3.6, §4.2 oracle row:
    "NumPy oracle vs each head").  Each head samples the same single-star
    scene; flux/position posterior moments must match the oracle within MC
    error (z-score gate).  Returns {"validated", "config", "heads"}."""
    import dataclasses

    import numpy as np

    from . import diagnostics
    from .api import sample
    from .configs import CONFIGS
    from .potential import constrain
    from oracle.numpy_sampler import run_oracle

    cfg = CONFIGS[config]
    truth_theta, img = cfg.make_data()
    x, y, f = constrain(truth_theta, cfg.scene)

    orc = run_oracle(
        np.asarray(img), cfg.scene.psf_sigma, cfg.scene.background,
        cfg.prior.logf_mean, cfg.prior.logf_sigma,
        n_stars=cfg.n_stars, n_chains=4, n_samples=2000, n_warmup=500,
        step_size=0.05, n_leapfrog=15, seed=1, theta0=np.asarray(truth_theta),
    )
    orc_draws = orc["samples"].reshape(4, -1, cfg.n_stars, 3)

    ok = True
    report = {}
    for head in heads:
        hcfg = dataclasses.replace(
            cfg, head=head, n_chains=16, n_samples=1000, n_warmup=400,
            smc=cfg.smc._replace(n_particles=2048, mutation="hmc",
                                 n_leapfrog=15, n_mutation_steps=3),
        )
        out = sample(hcfg, seed=2)
        draws = out.thetas  # (C, N, K, 3); SMC/ADVI: (P, 1, K, 3)
        if draws.shape[1] == 1:
            draws = np.moveaxis(draws, 0, 1)  # particles on the draw axis
        hrep = {}
        if head == "transdim":
            # Per-draw masks (trans-d chain): gate the ALIVE-SLOT marginal.
            # Conditional on the slot being alive, the posterior over
            # (ux, uy, logf) equals the oracle's fixed-K=1 posterior, so
            # dead draws are excluded; chains are trimmed to the minimum
            # alive count to stay rectangular.  On config 0 the death of
            # the only star explaining the image is essentially never
            # accepted, so the trim is ~a no-op (alive_frac reported).
            alive = np.asarray(out.masks)[:, :, 0] > 0.5     # (C, N)
            hrep["alive_frac"] = round(float(alive.mean()), 4)
            n_keep = int(alive.sum(1).min())
            if n_keep == 0:
                # a chain with zero alive draws in slot 0 leaves nothing to
                # gate on — fail with an explicit reason instead of letting
                # compare_moments NaN on empty arrays (ADVICE round 3)
                report[head] = {"validated": False,
                                "reason": "a chain has no alive slot-0 draws",
                                "moments": hrep}
                ok = False
                continue
            draws = np.stack([draws[c][alive[c]][:n_keep]
                              for c in range(draws.shape[0])])
        hok = True
        # ADVI is a mean-field APPROXIMATION: means must match, but its
        # variances are biased low by construction — gate on z of the mean
        # with a looser threshold (documented approximation, not a bug).
        zmax = 6.0 if head == "advi" else 4.0
        for j, nm in enumerate(["ux", "uy", "log_flux"]):
            cmp = diagnostics.compare_moments(
                draws[:, :, 0, j], orc_draws[:, :, 0, j], nm
            )
            hrep[nm] = {"z": round(cmp["z"], 2),
                        "head": round(cmp["a"]["mean"], 4),
                        "oracle": round(cmp["b"]["mean"], 4)}
            hok &= cmp["z"] < zmax
        report[head] = {"validated": bool(hok), "moments": hrep}
        if "kernel" in out.stats:
            report[head]["kernel"] = out.stats["kernel"]
        ok &= hok
    return {"validated": bool(ok), "config": cfg.name, "heads": report}


def cmd_validate(args):
    res = validate(args.config, args.heads.split(","))
    print(json.dumps(res, default=float))
    sys.exit(0 if res["validated"] else 1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="starcat")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list config presets")
    p_list.set_defaults(fn=cmd_list)

    p_run = sub.add_parser("run", help="run a preset")
    p_run.add_argument("--config", required=True)
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--checkpoint", default=None,
                       help="block-checkpoint file (SURVEY.md §5.4)")
    p_run.add_argument("--metrics", default=None,
                       help="JSONL per-window metrics sink (SURVEY.md §5.5)")
    p_run.add_argument("--resume", action="store_true",
                       help="continue a crashed run from --checkpoint (§5.3)")
    p_run.add_argument("overrides", nargs="*", help="key=value overrides")
    p_run.set_defaults(fn=cmd_run)

    p_rep = sub.add_parser("report", help="run a preset and save plots")
    p_rep.add_argument("--config", required=True)
    p_rep.add_argument("--seed", type=int, default=0)
    p_rep.add_argument("--out-prefix", default="starcat_report")
    p_rep.add_argument("overrides", nargs="*")
    p_rep.set_defaults(fn=cmd_report)

    p_val = sub.add_parser("validate", help="oracle vs JAX validation")
    p_val.add_argument("--config", default="cfg0_single_star")
    p_val.add_argument("--heads",
                       default="hmc,nuts,chees,rhmc,smc,advi,transdim",
                       help="comma-separated heads to gate against the oracle")
    p_val.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    from .runtime import configure_compile_cache

    configure_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
