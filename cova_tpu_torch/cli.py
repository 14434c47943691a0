"""Command-line interface of the port: ``train``, ``eval`` and ``predict``.

Counterpart of ``cova_tpu/cli.py`` with the same common flags, the same
subcommands' artifacts and locations, plus ``--device``. ``export``,
``visualize``, ``sweep`` and ``bench`` come with later slices.

    python -m cova_tpu_torch.cli train --synthetic 50 -e 5
    python -m cova_tpu_torch.cli eval --synthetic 50
    python -m cova_tpu_torch.cli predict --synthetic 50 --out_dir preds/

The model runs on ``cuda`` unless ``--device cpu`` is given; without a GPU
the default refuses to run instead of carrying on on the CPU. ``eval`` and
``predict`` take the fold's best checkpoint (``Fold-<k> saved_model.pt/
best.pt`` under the results directory) unless ``--torch_model`` names a
reference-format ``state_dict``; ``predict`` also finds the fold's exported
``Fold-<k> saved_model.pth``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .config import CLASS_NAMES, N_FOLDS, Config


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device: cuda (default), cuda:<n>, <n> (= "
                        "cuda:<n>), or cpu")
    p.add_argument("-e", "--n_epochs", type=int, default=50)
    p.add_argument("-lr", "--learning_rate", type=float, default=0.0005)
    p.add_argument("-bs", "--batch_size", type=int, default=5)
    p.add_argument("-cs", "--context_size", type=int, default=12)
    p.add_argument("-hd", "--hidden_dim", type=int, default=384)
    p.add_argument("-r", "--roi", type=int, default=3)
    p.add_argument("-bbhd", "--bbox_hidden_dim", type=int, default=32)
    p.add_argument("--use_additional_feat", dest="additional_feat",
                   action="store_true")
    p.add_argument("-wd", "--weight_decay", type=float, default=1e-3)
    p.add_argument("-dp", "--drop_prob", type=float, default=0.2)
    p.add_argument("-sf", "--sampling_fraction", type=float, default=0.9)
    p.add_argument("-nw", "--num_workers", type=int, default=5)
    p.add_argument("-cvf", "--cv_fold", type=int, default=1,
                   choices=[-1, *range(1, N_FOLDS + 1)])
    p.add_argument("--data_dir", default="../data")
    p.add_argument("--split_dir", default="splits")
    p.add_argument("--output_dir", default="results_5-Fold_CV")
    p.add_argument("--img_height", type=int, default=1280)
    p.add_argument("--backbone", default="resnet18_stem")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_devices", type=int, default=1,
                   help="devices (only 1 in this slice)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel factor (only 1 in this slice)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the last checkpoint if present")
    p.add_argument("--init_checkpoint", default=None, metavar="PATH.pth",
                   help="torchvision ResNet state_dict for the backbone "
                        "(not ported yet: refused)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_PAGES",
                   help="use N synthetic pages instead of data_dir")
    p.add_argument("--synthetic_hard", action="store_true",
                   help="harder synthetic task (colour-matched distractors)")
    p.add_argument("--decode_cache", default="", metavar="DIR",
                   help="decoded-screenshot cache (not ported yet: refused)")


def _cfg_from_args(args) -> Config:
    sf = args.sampling_fraction
    if not (0 <= sf <= 1):
        sf = 1.0  # the reference's clamping rule
    return Config(
        data_dir=args.data_dir,
        split_dir=args.split_dir,
        output_dir=args.output_dir,
        img_height=args.img_height,
        context_size=args.context_size,
        sampling_fraction=sf,
        num_workers=args.num_workers,
        roi=args.roi,
        hidden_dim=args.hidden_dim,
        bbox_hidden_dim=args.bbox_hidden_dim,
        use_additional_feat=args.additional_feat,
        drop_prob=args.drop_prob,
        backbone=args.backbone,
        compute_dtype=args.compute_dtype,
        n_epochs=args.n_epochs,
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        weight_decay=args.weight_decay,
        cv_fold=args.cv_fold,
        num_devices=args.num_devices,
        model_parallel=args.model_parallel,
        decode_cache=args.decode_cache,
    )


def resolve_device(name: str):
    """The torch device for ``--device``. CUDA is the default, and without
    a GPU it is an error, never a silent move to the CPU."""
    import torch

    if name.isdigit():
        name = f"cuda:{name}"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: CUDA is not available on this machine. The "
            "port runs on an NVIDIA GPU; pass --device cpu to run its plain "
            "PyTorch ops on the CPU instead."
        )
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return device


def _set_numerics(cfg: Config) -> None:
    import torch

    # f32 means f32: TF32 would round conv and matmul inputs to 10 mantissa
    # bits on the GPU (cuDNN convs use it by default).
    if cfg.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _refuse_unported(cfg: Config, args, command: str) -> None:
    if cfg.decode_cache:
        raise SystemExit("--decode_cache is not ported to cova_tpu_torch yet")
    if cfg.num_devices != 1 or cfg.model_parallel != 1:
        raise SystemExit(f"cova_tpu_torch {command} runs on one device "
                         "(multi-GPU is not ported yet)")
    if args.init_checkpoint:
        raise SystemExit("--init_checkpoint (pretrained backbone) is not "
                         "ported to cova_tpu_torch yet")


def _load_datasets(cfg: Config, args):
    """Returns (train_ds, val_ds, test_ds, webpage_info, test_domains);
    the last two are None where the fold has no domain files."""
    import numpy as np

    from .data.dataset import WebDataset, load_fold_ids
    from .data.synthetic import InMemoryWebDataset

    if args.synthetic:
        n = args.synthetic
        # Fold-rotated 60/20/20 split, as the JAX package's synthetic path.
        shift = ((cfg.cv_fold - 1) * n) // N_FOLDS if cfg.cv_fold > 0 else 0
        order = [(i + shift) % n for i in range(n)]
        splits = (
            order[0 : int(n * 0.6)],
            order[int(n * 0.6) : int(n * 0.8)],
            order[int(n * 0.8) : n],
        )
        base = InMemoryWebDataset(
            n, cfg.img_height, seed=cfg.seed, max_boxes=cfg.max_boxes,
            n_additional_feat=4 if cfg.use_additional_feat else 0,
            hard=args.synthetic_hard,
        )
        # Ten round-robin domains, as the JAX package synthesizes them, so
        # the domainwise and macro reports have rows.
        domains = np.array([f"synth{i % 10:02d}.com" for i in range(n)])
        webpage_info = np.stack([np.array(base.ids), domains], axis=1)
        test_domains = np.unique(domains[np.array(splits[2], np.int32)])
        return (*[base.subset(s) for s in splits], webpage_info,
                test_domains)

    from .data import native_loader

    train_ids, val_ids, test_ids, webpage_info, test_domains = (
        load_fold_ids(cfg.fold_dir)
    )
    native_loader.ensure_built()
    return (*(
        WebDataset(cfg.data_dir, ids, cfg.use_additional_feat,
                   img_size=cfg.img_height)
        for ids in (train_ids, val_ids, test_ids)
    ), webpage_info, test_domains)


def _build(cfg: Config, device, train_ds, val_ds, test_ds):
    """The model (initialised from ``cfg.seed``) on ``device``, its train
    state and the three pipelines."""
    from .data.pipeline import make_pipelines
    from .models.cova import build_model
    from .train.steps import create_train_state
    from .utils.params import count_parameters

    if train_ds.n_additional_feat:
        cfg = cfg.replace(n_additional_feat=train_ds.n_additional_feat)
    pipelines = make_pipelines(cfg, train_ds, val_ds, test_ds)
    model = build_model(cfg, device=device)
    state = create_train_state(model, cfg)
    # Trainable-parameter line at init (reference models.py:92).
    print("Model Parameters:", count_parameters(model))
    return (cfg, state, *pipelines)


def load_model(cfg: Config, device, torch_model: Optional[str] = None):
    """The eval-mode model of ``cfg`` on ``device``: the weights of
    ``torch_model`` (a reference-format state_dict, strict load), else the
    fold's best checkpoint, else the fold's exported ``.pth``."""
    from .models.cova import build_model
    from .utils.checkpoint import CheckpointManager, load_checkpoint
    from .utils.weights import load_state_dict_file

    best = CheckpointManager(cfg.ckpt_dir()).path("best")
    if torch_model:
        path, sd = torch_model, None
    elif os.path.isfile(best):
        path, sd = best, load_checkpoint(best)["model"]
    else:
        path, sd = cfg.torch_model_path(), None
    if sd is None:
        if not os.path.isfile(path):
            raise SystemExit(
                f"no weights at {path!r}: train the fold first (`train`) or "
                "pass --torch_model PATH.pth (a reference-format "
                "state_dict, e.g. from `cova export`)"
            )
        sd = load_state_dict_file(path)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    print(f"Serving checkpoint: {path}")
    return model.to(device)


def _log_header(cfg: Config, log_file: str) -> None:
    """The hyperparameter header of the fold's log (main.py:110-119)."""
    from .utils.logging import print_and_log

    print_and_log("Learning Rate: %.0e" % cfg.learning_rate, log_file, "w")
    print_and_log("Batch Size: %d" % cfg.batch_size, log_file)
    print_and_log("Context Size: %d" % cfg.context_size, log_file)
    print_and_log("Hidden Dim: %d" % cfg.gat_hidden_dim, log_file)
    print_and_log(
        "RoI Pool Output Size: (%d, %d)" % (cfg.roi, cfg.roi), log_file
    )
    print_and_log("BBox Hidden Dim: %d" % cfg.bbox_hidden_dim, log_file)
    print_and_log(
        "Use Additional Features: %s" % cfg.use_additional_feat, log_file
    )
    print_and_log("Weight Decay: %.0e" % cfg.weight_decay, log_file)
    print_and_log("Dropout Probability: %.2f" % cfg.drop_prob, log_file)
    print_and_log(
        "Sampling Fraction: %.2f\n" % cfg.sampling_fraction, log_file
    )


def cmd_train(args) -> int:
    """Train one fold: log, checkpoints, metrics, then the test reports and
    the fold's row of ``fold_wise_acc.csv``."""
    from .train.reporting import append_fold_row, evaluate
    from .train.trainer import fit
    from .utils.checkpoint import CheckpointManager
    from .utils.logging import MetricsLogger

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    _refuse_unported(cfg, args, "train")
    if args.synthetic_hard:
        raise SystemExit("train --synthetic_hard (with its oracle row) is "
                         "not ported to cova_tpu_torch yet")
    _set_numerics(cfg)
    train_ds, val_ds, test_ds, webpage_info, test_domains = _load_datasets(
        cfg, args
    )
    cfg, state, train_p, val_p, test_p = _build(
        cfg, device, train_ds, val_ds, test_ds
    )

    os.makedirs(cfg.results_dir, exist_ok=True)
    log_file = cfg.log_file()
    print(f'\n{"*"*20} Training on Fold-{cfg.cv_fold} {"*"*20}')
    print(f'logs will be saved in "{log_file}"')
    _log_header(cfg, log_file)

    ckpt = CheckpointManager(cfg.ckpt_dir())
    metrics = MetricsLogger(os.path.join(cfg.results_dir, "metrics.jsonl"))
    state, val_acc = fit(
        state, cfg, train_p, val_p, ckpt, log_file, metrics,
        class_names=CLASS_NAMES, resume=args.resume,
    )

    prefix = os.path.join(cfg.results_dir, f"Fold-{cfg.cv_fold} ")
    class_acc, macro_acc = evaluate(
        state.model, test_p, cfg.n_classes, CLASS_NAMES, log_file,
        prefix + "test_acc_imgwise.csv", webpage_info, test_domains,
        prefix + "test_acc_domainwise.csv", box_buckets=cfg.box_buckets,
    )
    append_fold_row(
        os.path.join(cfg.results_dir, "fold_wise_acc.csv"),
        cfg.cv_fold, val_acc, class_acc, macro_acc,
    )
    return 0


def cmd_eval(args) -> int:
    """Evaluate the fold's best checkpoint (or ``--torch_model``) on its
    test split; the reports go to the working directory, as the
    reference's ``evaluate.py`` writes them."""
    from .data.pipeline import make_eval_pipeline
    from .train.reporting import evaluate

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    _refuse_unported(cfg, args, "eval")
    _set_numerics(cfg)
    _, _, test_ds, webpage_info, test_domains = _load_datasets(cfg, args)
    if test_ds.n_additional_feat:
        cfg = cfg.replace(n_additional_feat=test_ds.n_additional_feat)
    model = load_model(cfg, device, args.torch_model)
    class_acc, macro_acc = evaluate(
        model, make_eval_pipeline(cfg, test_ds), cfg.n_classes, CLASS_NAMES,
        f"Fold-{cfg.cv_fold} test_acc_classwise.txt",
        f"Fold-{cfg.cv_fold} test_acc_imgwise.csv",
        webpage_info, test_domains,
        f"Fold-{cfg.cv_fold} test_acc_domainwise.csv",
        k=args.top_k, box_buckets=cfg.box_buckets,
    )
    print("Class acc:", class_acc[1:], "Macro acc:", macro_acc[1:])
    return 0


def cmd_predict(args) -> int:
    """Per-box class predictions, one CSV per page, plus ``retrieval.csv``
    (see ``train/predict.py``). Pages default to the fold's test split;
    ``--page_ids`` predicts arbitrary pages from ``--data_dir`` (their bbox
    CSVs' label column is ignored)."""
    from .data.pipeline import make_eval_pipeline
    from .train.predict import predict_pages

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    _refuse_unported(cfg, args, "predict")
    if args.page_ids and args.synthetic:
        raise SystemExit("--page_ids requires on-disk data, not "
                         "--synthetic (synthetic predicts its test split)")
    if args.render and args.synthetic:
        raise SystemExit("--render needs on-disk screenshots "
                         "(<data_dir>/imgs); synthetic pages have none")
    _set_numerics(cfg)
    if args.page_ids:
        from .data import native_loader
        from .data.dataset import WebDataset

        native_loader.ensure_built()
        pred_ds = WebDataset(
            cfg.data_dir, args.page_ids, cfg.use_additional_feat,
            img_size=cfg.img_height,
        )
    else:
        pred_ds = _load_datasets(cfg, args)[2]
    if pred_ds.n_additional_feat:
        cfg = cfg.replace(n_additional_feat=pred_ds.n_additional_feat)
    model = load_model(cfg, device, args.torch_model)
    out_dir = args.out_dir or os.path.join(
        cfg.results_dir, f"Fold-{cfg.cv_fold} predictions"
    )
    img_dir = os.path.join(cfg.data_dir, "imgs") if args.render else None
    summary = predict_pages(
        model, make_eval_pipeline(cfg, pred_ds), out_dir, CLASS_NAMES,
        max_pages=args.max_pages, box_buckets=cfg.box_buckets,
        img_dir=img_dir,
    )
    print(f"Predictions for {summary['pages']} pages saved in {out_dir}")
    print(json.dumps(summary))
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        "cova_tpu_torch",
        description="CoVA in PyTorch: context-aware webpage object detection",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn in (("train", cmd_train), ("eval", cmd_eval),
                     ("predict", cmd_predict)):
        p = sub.add_parser(name)
        _add_common_flags(p)
        p.set_defaults(fn=fn)
    for name in ("eval", "predict"):
        sub.choices[name].add_argument(
            "--torch_model", default=None, metavar="PATH.pth",
            help="reference-format state_dict to serve (default: the "
                 "fold's best checkpoint)")
    sub.choices["eval"].add_argument(
        "--top_k", type=int, default=1,
        help="retrieval depth k (published numbers use k=1)")
    p = sub.choices["predict"]
    p.add_argument(
        "--page_ids", type=str, nargs="+", default=None,
        help="predict these pages from --data_dir instead of the fold's "
             "test split (bbox CSV label column is ignored)")
    p.add_argument(
        "--out_dir", type=str, default=None,
        help="output dir (default: <results_dir>/Fold-<k> predictions)")
    p.add_argument("--max_pages", type=int, default=None)
    p.add_argument(
        "--render", action="store_true",
        help="also render <page_id>_pred.png overlays of the retrieval "
             "picks (requires on-disk screenshots)")
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
