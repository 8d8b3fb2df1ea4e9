"""Application layer: the reference's ``Main.main`` end to end (the JAX
package's ``app.py``).

Results page → parse table → featurize → CSV train/validation files →
two DMatrices with ``label_column=0`` → a booster trained on the TRAIN
matrix and a second one trained on the VALIDATION matrix, both with the
shared ``{train, test}`` watches → predict with both → ``check_predicts``
→ print the boolean. The reference's quirks stay: the second model trains
on the validation matrix, and the exact comparison of two different
models is in effect always false. The CSV bugs (no newlines, the typo'd
header) are fixed unless ``data.compat_csv`` asks for the reference's
bytes. Without the page's HTML the page at ``data.url`` is fetched
(data/fetch.py: retried with backoff; a FetchError exits 10).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np

from euromillioner_tpu_torch.config import Config
from euromillioner_tpu_torch.data.csvio import write_csv
from euromillioner_tpu_torch.data.pipeline import draws_from_html
from euromillioner_tpu_torch.train.trainer import check_predicts
from euromillioner_tpu_torch.trees import Booster, DMatrix, train
from euromillioner_tpu_torch.trees.gbt import resolve_train_device
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("app")


@dataclass
class ReferenceRunResult:
    booster: Booster
    booster_test: Booster
    predictions: np.ndarray         # train-model on train matrix
    predictions_test: np.ndarray    # validation-model on validation matrix
    predicts_equal: bool
    train_csv: str
    validation_csv: str


def run_reference_pipeline(
    cfg: Config | None = None,
    html: str | None = None,
    approx_atol: float | None = None,
    device=None,
) -> ReferenceRunResult:
    """The Main.java program, end to end, on ``device`` — the card unless
    ``"cpu"`` (None keeps ``cfg.gbt.device``, whose default ``auto`` is the
    card). ``html`` is the results page (e.g. the golden fixture);
    ``html=None`` fetches ``cfg.data.url``."""
    cfg = cfg or Config()
    params = cfg.gbt.xgb_params()
    if device is not None:
        params["device"] = str(device)
    resolve_train_device(params["device"])  # no card: fail before any work
    if html is None:
        from euromillioner_tpu_torch.data.fetch import fetch_url

        html = fetch_url(cfg.data.url)

    rows = draws_from_html(html, cfg.data)
    # chronological row split at write time
    cut = int((cfg.data.train_percent / 100.0) * len(rows))

    def temp_csv(prefix: str) -> str:
        fd, path = tempfile.mkstemp(prefix=prefix, suffix=".csv")
        os.close(fd)
        return path

    train_path = temp_csv("emn")
    val_path = temp_csv("emn_validation")
    write_csv(train_path, rows[:cut], compat=cfg.data.compat_csv)
    write_csv(val_path, rows[cut:], compat=cfg.data.compat_csv)

    if cfg.data.compat_csv:
        # the compat files reproduce the reference writer's bug (no
        # newlines) and cannot be parsed back; the matrices come from the
        # in-memory rows instead
        logger.warning("compat_csv files are reference-bug artifacts; "
                       "building DMatrices from parsed rows")
        data = np.asarray(rows, np.float32)
        lc = cfg.data.label_column

        def split(d):
            return DMatrix(np.delete(d, lc, axis=1), d[:, lc])
        train_matrix = split(data[:cut])
        validation_matrix = split(data[cut:])
    else:
        uri_suffix = f"?format=csv&label_column={cfg.data.label_column}"
        train_matrix = DMatrix(train_path + uri_suffix)
        validation_matrix = DMatrix(val_path + uri_suffix)

    watches = {"train": train_matrix, "test": validation_matrix}
    # two independent models, the second trained on the VALIDATION matrix
    booster = train(params, train_matrix, cfg.gbt.nround, evals=watches,
                    fuse_rounds=cfg.gbt.fuse_rounds)
    booster_test = train(params, validation_matrix, cfg.gbt.nround,
                         evals=watches, fuse_rounds=cfg.gbt.fuse_rounds)

    predict = booster.predict(train_matrix).reshape(-1, 1)
    predict_test = booster_test.predict(validation_matrix).reshape(-1, 1)
    equal = check_predicts(predict, predict_test, atol=approx_atol)
    # the reference's entire program output
    print(equal)
    return ReferenceRunResult(
        booster=booster,
        booster_test=booster_test,
        predictions=predict,
        predictions_test=predict_test,
        predicts_equal=equal,
        train_csv=train_path,
        validation_csv=val_path,
    )
