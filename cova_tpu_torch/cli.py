"""Command-line interface of the port: ``train``, ``eval``, ``predict``,
``visualize``, ``sweep``, ``export`` and ``bench``.

Counterpart of ``cova_tpu/cli.py`` with the same common flags, the same
subcommands' artifacts and locations, plus ``--device``. ``--backbone``
takes the whole registry of ``models.resnet.make_backbone``; ``train
--init_checkpoint`` initialises the backbone from a torchvision state_dict
and ``--decode_cache`` keeps decoded screenshots on disk.

    python -m cova_tpu_torch.cli train --synthetic 50 -e 5
    python -m cova_tpu_torch.cli eval --synthetic 50
    python -m cova_tpu_torch.cli predict --synthetic 50 --out_dir preds/
    python -m cova_tpu_torch.cli visualize --synthetic 50 --no_render
    python -m cova_tpu_torch.cli sweep --synthetic 50 --folds 1 2
    python -m cova_tpu_torch.cli export --synthetic 50
    python -m cova_tpu_torch.cli bench --mode infer -bsb 32

The model runs on ``cuda`` unless ``--device cpu`` is given; without a GPU
the default refuses to run instead of carrying on on the CPU. ``eval``,
``predict`` and ``visualize`` take the fold's best checkpoint (``Fold-<k>
saved_model.pt/best.pt`` under the results directory) unless
``--torch_model`` names a reference-format ``state_dict``; they also find
the fold's exported ``Fold-<k> saved_model.pth``, which ``export`` writes.
``train --synthetic_hard`` appends the generator's Bayes-oracle band to
``oracle_acc.csv``; ``sweep`` trains each fold in this process and
aggregates ``fold_wise_acc.csv`` into ``sweep_summary.txt``. ``bench``
prints one JSON line (``benchmarks.py``).

Several devices (``train``, ``eval`` and ``sweep``; the other subcommands
run on one device, as the JAX package's do):

    python -m cova_tpu_torch.cli train --num_devices 2 --device cpu
    python -m cova_tpu_torch.cli train --num_devices 4 --model_parallel 2

``--num_devices N`` starts N ranks on this host (``parallel/launch.py``);
a launch through ``COVA_COORDINATOR_ADDRESS``, ``COVA_NUM_PROCESSES`` and
``COVA_PROCESS_ID`` (``parallel/distributed.py``) runs one rank per process
and defaults to every rank. The ranks form a (data, model) mesh
(``parallel/mesh.py``); rank 0 prints and writes the artifacts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .config import BACKBONES, CLASS_NAMES, N_FOLDS, Config


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
    p.add_argument("--backbone", default="resnet18_stem",
                   choices=list(BACKBONES))
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_devices", type=int, default=1,
                   help="devices (ranks) of the (data, model) mesh of "
                        "train/eval/sweep: 1 = one device, 0 = all, N = "
                        "exactly N (started on this host unless the "
                        "COVA_* launch environment is set)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel factor within num_devices "
                        "(the GAT projections and the decoder's hidden "
                        "layer)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the last checkpoint if present")
    p.add_argument("--init_checkpoint", default=None, metavar="PATH.pth",
                   help="torchvision ResNet state_dict to initialise the "
                        "backbone from (train only; the canonical file name "
                        "is held to its sha256 pin, see "
                        "utils/pretrained.py)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_PAGES",
                   help="use N synthetic pages instead of data_dir")
    p.add_argument("--synthetic_hard", action="store_true",
                   help="harder synthetic task (colour-matched distractors)")
    p.add_argument("--decode_cache", default="", metavar="DIR",
                   help="cache decoded screenshots as .npy under DIR so "
                        "that later epochs and runs skip the PNG inflate "
                        "(costs one decoded copy on disk)")


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


def _device_name(name: str) -> str:
    return f"cuda:{name}" if name.isdigit() else name


def resolve_device(name: str):
    """The torch device for ``--device``. CUDA is the default, and without
    a GPU it is an error, never a silent move to the CPU. In a multi-rank
    launch ``cuda`` is this rank's card (``distributed.rank_device``)."""
    import torch

    from .parallel.distributed import rank_device

    name = _device_name(name)
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: CUDA is not available on this machine. The "
            "port runs on an NVIDIA GPU; pass --device cpu to run its plain "
            "PyTorch ops on the CPU instead."
        )
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return rank_device(name)


def _set_numerics(cfg: Config) -> None:
    import torch

    # f32 means f32: TF32 would round conv and matmul inputs to 10 mantissa
    # bits on the GPU (cuDNN convs use it by default).
    if cfg.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _launch_mesh(cfg: Config):
    """(cfg, the mesh of a ``train`` or ``eval`` run; None on one device).
    A multi-process launch means every rank: ``--num_devices 1`` becomes 0
    there."""
    from .parallel import distributed
    from .parallel.mesh import mesh_from_config
    from .utils.logging import print_and_log

    if distributed.is_multiprocess() and cfg.num_devices == 1:
        print_and_log(
            f"Multi-host launch ({distributed.world_size()} processes): "
            "using all global devices (--num_devices 0)", None,
        )
        cfg = cfg.replace(num_devices=0)
    mesh = mesh_from_config(cfg)
    return cfg, mesh


def _mesh_line(mesh, device) -> str:
    """``Mesh: {'data': d, 'model': m}``, then the backend and each rank's
    device (on one host: rank r holds ``cuda:(r % device_count)``)."""
    import torch

    from .parallel import distributed

    n = distributed.world_size()
    if device.type == "cuda":
        k = torch.cuda.device_count()
        devices = [f"cuda:{r % k}" for r in range(n)]
    else:
        devices = ["cpu"] * n
    return "Mesh: %s backend: %s devices: %s" % (
        mesh.shape, distributed.backend(), ",".join(devices))


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
                   img_size=cfg.img_height,
                   decode_cache_dir=cfg.decode_cache or None)
        for ids in (train_ids, val_ids, test_ids)
    ), webpage_info, test_domains)


def _build(cfg: Config, device, train_ds, val_ds, test_ds, mesh=None):
    """The model (initialised from ``cfg.seed``) on ``device``, its train
    state laid out on ``mesh`` and the three pipelines (train: this rank's
    stripe)."""
    from .data.pipeline import make_pipelines
    from .models.cova import build_model
    from .train.steps import create_train_state
    from .utils.logging import print_and_log
    from .utils.params import count_parameters

    if train_ds.n_additional_feat:
        cfg = cfg.replace(n_additional_feat=train_ds.n_additional_feat)
    pipelines = make_pipelines(
        cfg, train_ds, val_ds, test_ds,
        host_shard=mesh.host_shard if mesh is not None else None)
    model = build_model(cfg, device=device)
    # Trainable-parameter line at init (reference models.py:92).
    print_and_log("Model Parameters: %d" % count_parameters(model), None)
    state = create_train_state(model, cfg, mesh)
    return (cfg, state, *pipelines)


def load_model(cfg: Config, device, torch_model: Optional[str] = None,
               mesh=None):
    """The eval-mode model of ``cfg`` on ``device``: the weights of
    ``torch_model`` (a reference-format state_dict, strict load), else the
    fold's best checkpoint, else the fold's exported ``.pth``; laid out on
    ``mesh`` when one is given."""
    from .models.cova import build_model
    from .parallel.mesh import parallelize
    from .utils.checkpoint import CheckpointManager, load_checkpoint
    from .utils.logging import print_and_log
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
    print_and_log(f"Serving checkpoint: {path}", None)
    return parallelize(model, mesh).to(device)


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
    from .utils.logging import MetricsLogger, print_and_log

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    if args.init_checkpoint and not os.path.isfile(args.init_checkpoint):
        raise SystemExit(f"--init_checkpoint {args.init_checkpoint}: no "
                         "such file")
    _set_numerics(cfg)
    cfg, mesh = _launch_mesh(cfg)
    train_ds, val_ds, test_ds, webpage_info, test_domains = _load_datasets(
        cfg, args
    )
    cfg, state, train_p, val_p, test_p = _build(
        cfg, device, train_ds, val_ds, test_ds, mesh
    )
    if args.init_checkpoint:
        from .utils.pretrained import init_backbone_from_checkpoint

        init_backbone_from_checkpoint(state.model, cfg.backbone,
                                      args.init_checkpoint)

    os.makedirs(cfg.results_dir, exist_ok=True)
    log_file = cfg.log_file()
    print_and_log(f'\n{"*"*20} Training on Fold-{cfg.cv_fold} {"*"*20}',
                  None)
    print_and_log(f'logs will be saved in "{log_file}"', None)
    _log_header(cfg, log_file)
    if mesh is not None:
        print_and_log(_mesh_line(mesh, device), log_file)

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
        mesh=mesh,
    )
    append_fold_row(
        os.path.join(cfg.results_dir, "fold_wise_acc.csv"),
        cfg.cv_fold, val_acc, class_acc, macro_acc,
    )
    if args.synthetic and args.synthetic_hard:
        _append_oracle_row(cfg, test_ds, log_file)
    return 0


def _append_oracle_row(cfg: Config, test_ds, log_file: str) -> None:
    """Score the fold's test split with the hard generator's own Bayes rule
    and record the ceiling band beside the model's scores: 'latent' reads
    the assigned box colours (what any model could reach with perfect
    observation), 'visible' re-estimates them from the rendered pixels (a
    pixels-only rule, which folds occlusion in). The oracle reads only the
    data."""
    from .data.synthetic import oracle_retrieval_correct
    from .parallel.distributed import is_primary
    from .utils.logging import print_and_log

    if not is_primary():
        return
    lat = oracle_retrieval_correct(test_ds).mean(axis=0) * 100
    vis = oracle_retrieval_correct(test_ds, visible=True).mean(axis=0) * 100
    for name, acc in (("latent", lat), ("visible", vis)):
        print_and_log(
            "[ORACLE %s] Price: %.2f%% Title: %.2f%% Image: %.2f%%"
            % (name, acc[0], acc[1], acc[2]),
            log_file,
        )
    path = os.path.join(cfg.results_dir, "oracle_acc.csv")
    new = not os.path.isfile(path)
    with open(path, "a") as f:
        if new:
            f.write(
                "fold,price_latent,title_latent,image_latent,"
                "price_visible,title_visible,image_visible\n"
            )
        f.write(
            "%d,%.2f,%.2f,%.2f,%.2f,%.2f,%.2f\n"
            % (cfg.cv_fold, *lat, *vis)
        )


def cmd_eval(args) -> int:
    """Evaluate the fold's best checkpoint (or ``--torch_model``) on its
    test split; the reports go to the working directory, as the
    reference's ``evaluate.py`` writes them."""
    from .data.pipeline import make_eval_pipeline
    from .parallel.distributed import is_primary
    from .train.reporting import evaluate
    from .utils.logging import print_and_log

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    _set_numerics(cfg)
    cfg, mesh = _launch_mesh(cfg)
    if mesh is not None:
        print_and_log(_mesh_line(mesh, device), None)
    _, _, test_ds, webpage_info, test_domains = _load_datasets(cfg, args)
    if test_ds.n_additional_feat:
        cfg = cfg.replace(n_additional_feat=test_ds.n_additional_feat)
    model = load_model(cfg, device, args.torch_model, mesh)
    class_acc, macro_acc = evaluate(
        model, make_eval_pipeline(cfg, test_ds), cfg.n_classes, CLASS_NAMES,
        f"Fold-{cfg.cv_fold} test_acc_classwise.txt",
        f"Fold-{cfg.cv_fold} test_acc_imgwise.csv",
        webpage_info, test_domains,
        f"Fold-{cfg.cv_fold} test_acc_domainwise.csv",
        k=args.top_k, box_buckets=cfg.box_buckets, mesh=mesh,
    )
    if is_primary():
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
            decode_cache_dir=cfg.decode_cache or None,
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


def cmd_export(args) -> int:
    """Write the fold's best checkpoint as a reference-format
    ``state_dict`` (f32 floats) to ``<results_dir>/Fold-<k>
    saved_model.pth``, where the reference's ``evaluate.py`` and
    visualization script look for it. The port's modules use the
    reference's namespace, so the keys carry over as they are; each BN's
    ``num_batches_tracked`` holds the steps it counted (the JAX package
    writes 0; the reference never reads it)."""
    import torch

    from .models.cova import build_model
    from .utils.checkpoint import CheckpointManager, load_checkpoint

    cfg = _cfg_from_args(args)
    resolve_device(args.device)  # checked as everywhere; export runs on host
    if cfg.use_additional_feat and cfg.n_additional_feat == 0:
        # Discovered from the data elsewhere; export has no dataset in
        # hand, so the flag gives it (synthetic and the reference's
        # CoVA++ data both carry 4).
        cfg = cfg.replace(n_additional_feat=args.n_feat)
    if cfg.backbone != "resnet18_stem":
        raise SystemExit(
            "export targets the reference architecture (models.py:48-56), "
            f"which uses the truncated resnet18 stem; got --backbone "
            f"{cfg.backbone}"
        )
    best = CheckpointManager(cfg.ckpt_dir()).path("best")
    if not os.path.isfile(best):
        raise SystemExit(
            "Model does not seem to have been trained (run `train`) with "
            "the hyperparameters you provided"
        )
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_checkpoint(best)["model"], strict=True)
    sd = {k: (v.float() if v.is_floating_point() else v).contiguous()
          for k, v in model.state_dict().items()}
    out = args.out or cfg.torch_model_path()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.save(sd, out)
    print(f"Exported reference-format checkpoint ({len(sd)} tensors) "
          f"to {out}")
    return 0


def cmd_visualize(args) -> int:
    """Attention CSVs (and, unless ``--no_render``, overlay PNGs) for the
    fold's test pages, into ``<results_dir>/Fold-<k> attention
    visualization`` (see ``train/extract.py``)."""
    from .data.pipeline import make_eval_pipeline
    from .train.extract import extract_attention

    cfg = _cfg_from_args(args)
    if cfg.context_size <= 0:
        raise SystemExit(
            "Attention Scores can only be computed if CONTEXT_SIZE > 0")
    device = resolve_device(args.device)
    _set_numerics(cfg)
    _, _, test_ds, _, _ = _load_datasets(cfg, args)
    if test_ds.n_additional_feat:
        cfg = cfg.replace(n_additional_feat=test_ds.n_additional_feat)
    model = load_model(cfg, device, args.torch_model)
    out_dir = os.path.join(
        cfg.results_dir, f"Fold-{cfg.cv_fold} attention visualization"
    )
    data_dir = cfg.data_dir
    tmp_imgs = None
    if args.synthetic:
        if args.no_render:
            data_dir = None
        else:
            # The overlays read imgs/<id>.png, as the reference's layout;
            # synthetic pages live in memory, so the pages to extract are
            # written out first (the eval pipeline keeps dataset order).
            import tempfile

            from PIL import Image

            tmp_imgs = tempfile.TemporaryDirectory()
            img_dir = os.path.join(tmp_imgs.name, "imgs")
            os.makedirs(img_dir)
            n = args.max_pages or len(test_ds.ids)
            for idx, pid in enumerate(test_ds.ids[:n]):
                Image.fromarray(test_ds.image(idx)).save(
                    os.path.join(img_dir, f"{pid}.png")
                )
            data_dir = tmp_imgs.name
    try:
        extract_attention(
            model, make_eval_pipeline(cfg, test_ds), data_dir, out_dir,
            visualize=not args.no_render and data_dir is not None,
            max_pages=args.max_pages,
        )
    finally:
        if tmp_imgs is not None:
            tmp_imgs.cleanup()
    return 0


def sweep_summary(fold_wise_acc_file: str, folds) -> Optional[str]:
    """Aggregate ``fold_wise_acc.csv`` into the published table's format:
    per class, mean ± std over folds. A re-run fold leaves stale rows; the
    last row per fold wins. With an ``oracle_acc.csv`` beside it, the
    oracle band is aggregated the same way. Returns the summary text, or
    None if no requested fold has a row yet."""
    import numpy as np

    rows = np.loadtxt(
        fold_wise_acc_file, delimiter=",", skiprows=1, ndmin=2
    )
    by_fold = {}
    for r in rows:
        by_fold[int(r[0])] = r  # later rows overwrite earlier ones
    got = [by_fold[f] for f in folds if f in by_fold]
    if not got:
        return None
    acc = np.stack(got)  # columns: fold,val,P,Pm,T,Tm,I,Im
    lines = [f"folds: {[f for f in folds if f in by_fold]}"]
    for label, cols in (("classwise", (2, 4, 6)), ("macro", (3, 5, 7))):
        parts = [
            "%s %.1f ± %.1f" % (name, acc[:, c].mean(), acc[:, c].std())
            for name, c in zip(("Price", "Title", "Image"), cols)
        ]
        lines.append(f"{label}: " + " | ".join(parts))
    oracle_path = os.path.join(
        os.path.dirname(fold_wise_acc_file), "oracle_acc.csv"
    )
    if os.path.isfile(oracle_path):
        orows = np.loadtxt(
            oracle_path, delimiter=",", skiprows=1, ndmin=2
        )
        o_by_fold = {int(r[0]): r for r in orows}
        o_got = [o_by_fold[f] for f in folds if f in o_by_fold]
        if o_got:
            oacc = np.stack(o_got)
            for label, cols in (
                ("oracle latent", (1, 2, 3)),
                ("oracle visible", (4, 5, 6)),
            ):
                parts = [
                    "%s %.1f ± %.1f"
                    % (name, oacc[:, c].mean(), oacc[:, c].std())
                    for name, c in zip(("Price", "Title", "Image"), cols)
                ]
                lines.append(f"{label}: " + " | ".join(parts))
    return "\n".join(lines) + "\n"


def cmd_sweep(args) -> int:
    """Cross-validation sweep: train each of ``--folds`` in this process,
    one ``cmd_train`` call per fold (nothing re-executes the process, so a
    fold cannot restart the sweep), then aggregate into the published
    mean ± std table, ``sweep_summary.txt``."""
    from .parallel.distributed import is_primary

    rc = 0
    for fold in args.folds:
        fold_args = argparse.Namespace(**vars(args))
        fold_args.cv_fold = fold
        if is_primary():
            print(f"\n===== Fold {fold} =====")
        rc |= cmd_train(fold_args)
    cfg = _cfg_from_args(args)
    path = os.path.join(cfg.results_dir, "fold_wise_acc.csv")
    if rc == 0 and os.path.isfile(path) and is_primary():
        summary = sweep_summary(path, args.folds)
        if summary:
            print("\n===== Sweep summary (mean ± std over folds) =====")
            print(summary, end="")
            with open(
                os.path.join(cfg.results_dir, "sweep_summary.txt"), "w"
            ) as f:
                f.write(summary)
    return rc


def cmd_bench(args) -> int:
    """One benchmark (``benchmarks.py``), printed as one JSON line."""
    from . import benchmarks

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    _set_numerics(cfg)
    # -bs and --batch_size_bench are one knob here: bench's parser
    # defaults batch_size to None so that an explicit -bs is seen; -bsb
    # wins when both are given.
    bs = args.batch_size_bench
    if bs is None:
        bs = args.batch_size if args.batch_size is not None else 8
    if args.mode == "e2e":
        result = benchmarks.run_e2e_bench(
            batch_size=bs,
            n_pages=args.e2e_pages,
            epochs=args.e2e_epochs,
            img_height=args.img_height,
            compute_dtype=args.compute_dtype,
            source=args.e2e_source,
            use_additional_feat=args.additional_feat,
            # None (not given) -> the bench's own min(8, cpus).
            num_threads=args.num_workers or 0,
            device=device,
        )
    else:
        fn = (benchmarks.run_infer_bench if args.mode == "infer"
              else benchmarks.run_train_bench)
        result = fn(
            batch_size=bs,
            steps=args.steps,
            img_height=args.img_height,
            compute_dtype=args.compute_dtype,
            use_additional_feat=args.additional_feat,
            backbone=args.backbone,
            context_size=args.context_size,
            device=device,
        )
    print(json.dumps(result))
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        "cova_tpu_torch",
        description="CoVA in PyTorch: context-aware webpage object detection",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn in (("train", cmd_train), ("eval", cmd_eval),
                     ("predict", cmd_predict), ("visualize", cmd_visualize),
                     ("sweep", cmd_sweep), ("export", cmd_export)):
        p = sub.add_parser(name)
        _add_common_flags(p)
        p.set_defaults(fn=fn)
    for name in ("eval", "predict", "visualize"):
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
    p = sub.choices["export"]
    p.add_argument(
        "--out", default=None, metavar="PATH.pth",
        help="output file (default: '<results_dir>/Fold-<k> "
             "saved_model.pth', where the reference's evaluate.py looks)")
    p.add_argument(
        "--n_feat", type=int, default=4,
        help="additional-feature count with --use_additional_feat (export "
             "has no dataset to discover it from)")
    p = sub.choices["visualize"]
    p.add_argument("--no_render", action="store_true")
    p.add_argument("--max_pages", type=int, default=None)
    sub.choices["sweep"].add_argument(
        "--folds", type=int, nargs="+",
        default=list(range(1, N_FOLDS + 1)),
    )

    b = sub.add_parser("bench")
    _add_common_flags(b)
    # None sentinels: an explicit -bs / -nw is seen (and honored) by
    # cmd_bench; unset falls back to the bench's own defaults (bs 8; e2e
    # threads min(8, cpus)).
    b.set_defaults(batch_size=None, num_workers=None)
    b.add_argument("--steps", type=int, default=20,
                   help="steps per timed window (train/infer modes; e2e "
                        "is epoch-timed: use --e2e_pages/--e2e_epochs)")
    b.add_argument("--batch_size_bench", "-bsb", type=int, default=None,
                   help="bench batch size (alias: the common -bs flag; "
                        "default 8)")
    b.add_argument("--e2e_pages", type=int, default=64,
                   help="e2e mode: synthetic pages per epoch")
    b.add_argument("--e2e_epochs", type=int, default=3,
                   help="e2e mode: timed epochs (after one warm epoch)")
    b.add_argument("--mode", choices=["train", "infer", "e2e"],
                   default="train",
                   help="train = fwd+bwd+update (device-staged batch); "
                        "infer = serving forward (use -bs 1 for single-"
                        "page latency); e2e = batches fed from the host "
                        "DataPipeline (sustained throughput)")
    b.add_argument("--e2e_source", choices=["mem", "disk"], default="mem",
                   help="e2e feed: mem = in-memory synthetic pages; disk = "
                        "PNGs/CSVs through the native decode path with "
                        "the decoded-screenshot cache (steady-state epochs "
                        "are cache-warm)")
    b.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    if args.command not in MULTI_RANK:
        return args.fn(args)
    from .parallel import distributed

    if not distributed.launched():
        n = _ranks_to_start(args)
        if n > 1:
            from .parallel.launch import spawn

            return spawn(sys.argv[1:] if argv is None else list(argv), n)
    distributed.initialize(_device_name(args.device))
    try:
        return args.fn(args)
    finally:
        distributed.shutdown()


# The subcommands that run on several ranks; the others run on one device.
MULTI_RANK = ("train", "eval", "sweep")


def _ranks_to_start(args) -> int:
    """The ranks ``--num_devices`` asks this process to start (1: run
    here), after the mesh's checks: on ``cuda`` at most the visible cards
    (0 = all of them); on the CPU any number (0 = one)."""
    import torch

    from .parallel.mesh import mesh_from_config

    n = args.num_devices
    if resolve_device(args.device).type == "cuda":
        visible = torch.cuda.device_count()
    else:
        visible = max(n, 1)
    mesh = mesh_from_config(_cfg_from_args(args), n_visible=visible)
    return 1 if mesh is None else mesh.n_data * mesh.n_model


if __name__ == "__main__":
    sys.exit(main())
