"""Per-page prediction export: the serving surface.

Counterpart of ``cova_tpu/train/predict.py``, with the same artifacts:

* ``<out_dir>/<page_id>.csv``: one row per valid box,
  ``x,y,w,h,pred,p_<class>...`` (bbox in x/y/w/h, the argmax class id, then
  one softmax probability per class);
* ``<out_dir>/retrieval.csv``: per page and non-BG class, the valid box
  with the highest class logit (the reference's ranking at k=1), as
  ``page_id,class,box_index,x,y,w,h,score`` with ``score`` its softmax
  probability for that class.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..data.batching import bucket_batch, pad_batch
from ..data.device_prefetch import device_prefetch
from .steps import forward_step


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def predict_pages(
    model,
    pipeline,
    out_dir: str,
    class_names: Sequence[str],
    max_pages: Optional[int] = None,
    box_buckets: Sequence[int] = (),
    img_dir: Optional[str] = None,
) -> dict:
    """Run ``model`` over every page of ``pipeline`` (eval-style: no
    shuffle, no sampling), writing ``<out_dir>/<page_id>.csv`` per page and
    ``retrieval.csv``. ``img_dir`` (a directory of ``<page_id>.png``) also
    renders ``<page_id>_pred.png`` overlays of the retrieval picks.

    Returns a summary dict: ``pages``, ``boxes``, ``batches`` and per-class
    predicted box counts (keyed by class name).
    """
    os.makedirs(out_dir, exist_ok=True)
    eval_bs = pipeline.batch_size
    n_classes = len(class_names)
    header = "x,y,w,h,pred," + ",".join(f"p_{c}" for c in class_names)
    counts = np.zeros(n_classes, np.int64)
    retrieval_rows = []
    n_done = n_boxes = n_batches = 0

    def finish():
        with open(os.path.join(out_dir, "retrieval.csv"), "w") as f:
            f.write("page_id,class,box_index,x,y,w,h,score\n")
            f.write("".join(r + "\n" for r in retrieval_rows))
        s = {"pages": n_done, "boxes": n_boxes, "batches": n_batches}
        s.update({c: int(n) for c, n in zip(class_names, counts)})
        return s

    def padded_batches():
        for ids, batch in pipeline.epoch(0):
            padded, _ = pad_batch(batch, eval_bs)
            if box_buckets:
                padded = bucket_batch(padded, tuple(box_buckets))
            yield (ids, batch), padded

    device = next(model.parameters()).device
    for (ids, batch), _, on_device in device_prefetch(padded_batches(),
                                                      device):
        if max_pages is not None and n_done >= max_pages:
            break
        real_b = batch.batch_size
        out = forward_step(model, on_device)
        n_batches += 1
        logits = out.logits.cpu().numpy()  # [B, P', C] float32
        probs = _softmax(logits)
        preds = np.argmax(logits, axis=-1)
        p_used = logits.shape[1]
        for i in range(real_b):
            if max_pages is not None and n_done >= max_pages:
                break
            mask = batch.box_mask[i][:p_used]
            xywh = batch.boxes[i][:p_used].copy()
            xywh[:, 2:] -= xywh[:, :2]
            rows = np.concatenate(
                [
                    xywh[mask],
                    preds[i][mask, None].astype(np.float32),
                    probs[i][mask],
                ],
                axis=1,
            )
            np.savetxt(
                os.path.join(out_dir, f"{ids[i]}.csv"),
                rows,
                delimiter=",",
                fmt=["%.4f"] * 4 + ["%d"] + ["%.4f"] * n_classes,
                header=header,
                comments="",
            )
            counts += np.bincount(preds[i][mask], minlength=n_classes)
            n_boxes += int(mask.sum())
            col = np.where(mask[:, None], logits[i], -np.inf)  # [P', C]
            picks = []
            if mask.any():
                for c in range(1, n_classes):
                    j = int(np.argmax(col[:, c]))
                    picks.append((
                        class_names[c],
                        *(float(v) for v in xywh[j]),
                        float(probs[i][j, c]),
                    ))
                    retrieval_rows.append(
                        f"{ids[i]},{class_names[c]},{j},"
                        + ",".join(f"{v:.4f}" for v in xywh[j])
                        + f",{probs[i][j, c]:.4f}"
                    )
            if img_dir is not None and picks:
                from ..utils.visualize import visualize_predictions

                visualize_predictions(
                    os.path.join(img_dir, f"{ids[i]}.png"),
                    picks,
                    os.path.join(out_dir, f"{ids[i]}_pred.png"),
                )
            n_done += 1
    return finish()
