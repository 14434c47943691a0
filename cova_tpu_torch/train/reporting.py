"""Test-set reporting: imgwise / domainwise CSVs and macro accuracy.

Counterpart of ``cova_tpu/train/reporting.py``, with the reference's
artifact schema byte for byte (the CSV files are its de-facto API):

  * ``Fold-k test_acc_imgwise.csv``: header ``img_id,price_acc,title_acc,
    image_acc``, one 0/1 row per test page;
  * ``Fold-k test_acc_domainwise.csv``: per test domain, page count and
    per-class mean accuracy;
  * macro accuracy = unweighted mean of the domain rows, each rounded to
    two decimals first, as the reference re-reads its own CSV.

In a multi-rank run every rank computes the reports and rank 0 alone
writes them.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..parallel.distributed import is_primary
from ..utils.logging import print_and_log
from .trainer import run_eval


def evaluate(
    model,
    test_pipeline,
    n_classes: int,
    class_names,
    log_file: Optional[str],
    test_acc_imgwise_file: str,
    webpage_info: Optional[np.ndarray] = None,
    test_domains: Optional[np.ndarray] = None,
    test_acc_domainwise_file: Optional[str] = None,
    k: int = 1,
    box_buckets=(),
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (class_acc_test, macro_acc_test), each [n_classes] in %.
    ``mesh``: the layout ``model`` runs on (``run_eval`` shards the pages
    over its data axis)."""
    if is_primary():
        print(
            "Evaluating classwise, imgwise (webpagewise), and domainwise "
            "accuracies on test data..."
        )
    img_acc, class_acc_test = run_eval(
        model, test_pipeline, n_classes, class_names, "TEST", log_file, k=k,
        box_buckets=tuple(box_buckets), mesh=mesh,
    )
    if is_primary():
        np.savetxt(
            test_acc_imgwise_file,
            img_acc,
            "%s,%.2f,%.2f,%.2f",
            ",",
            header="img_id,price_acc,title_acc,image_acc",
            comments="",
        )

    macro_acc_test = np.zeros(len(class_names))
    if (
        test_domains is None
        or webpage_info is None
        or test_acc_domainwise_file is None
    ):
        return class_acc_test, macro_acc_test
    domain_rows = []
    lines = [
        "Domain,N_examples,%s,%s,%s\n"
        % (class_names[1], class_names[2], class_names[3])
    ]
    for domain in np.atleast_1d(test_domains):
        domain_imgs = webpage_info[
            np.isin(webpage_info[:, 1], domain), 0
        ].astype(np.int32)
        sel = np.isin(img_acc[:, 0], domain_imgs)
        domain_class_acc = img_acc[sel, 1:].mean(0) * 100
        domain_rows.append(domain_class_acc)
        lines.append(
            "%s,%d,%.2f,%.2f,%.2f\n"
            % (domain, len(domain_imgs), *domain_class_acc[:3])
        )
    if is_primary():
        with open(test_acc_domainwise_file, "w") as f:
            f.writelines(lines)
    macro_acc_test[1:] = np.round(np.array(domain_rows), 2).mean(0)
    for c in range(1, len(class_names)):
        print_and_log(
            "%s Macro Acc: %.2f%%" % (class_names[c], macro_acc_test[c]),
            log_file,
        )
    return class_acc_test, macro_acc_test


def append_fold_row(
    fold_wise_acc_file: str,
    cv_fold: int,
    val_acc: float,
    class_acc_test: np.ndarray,
    macro_acc_test: np.ndarray,
):
    """Append one row to ``fold_wise_acc.csv`` (header first; rank 0
    only)."""
    if not is_primary():
        return
    with open(fold_wise_acc_file, "a") as f:
        if os.stat(fold_wise_acc_file).st_size == 0:
            f.write(
                "Fold,val_avg,price_acc,price_macro_acc,title_acc,"
                "title_macro_acc,image_acc,image_macro_acc\n"
            )
        f.write(
            "%s,%.2f,%.2f,%.2f,%.2f,%.2f,%.2f,%.2f\n"
            % (
                cv_fold,
                val_acc,
                class_acc_test[1],
                macro_acc_test[1],
                class_acc_test[2],
                macro_acc_test[2],
                class_acc_test[3],
                macro_acc_test[3],
            )
        )
