"""Classical ML toolkit (the JAX package's ``classic/``, the weka-dev
capability): logistic regression, a linear SVM, Gaussian naive Bayes and
k-means. Every fit is tensor ops on the model's device (the card unless
``device="cpu"``); every predict one forward there. The JSON model dumps
are the JAX package's, so either package loads the other's.
"""

import json

from euromillioner_tpu_torch.classic.kmeans import KMeans
from euromillioner_tpu_torch.classic.linear import (LinearSVM,
                                                    LogisticRegression)
from euromillioner_tpu_torch.classic.naive_bayes import GaussianNB
from euromillioner_tpu_torch.utils.errors import DataError

# JSON model-dump "kind" tag → class (save_model/load_model on each)
CLASSIC_KINDS = {LogisticRegression.kind: LogisticRegression,
                 LinearSVM.kind: LinearSVM,
                 GaussianNB.kind: GaussianNB,
                 KMeans.kind: KMeans}


def load_classic_model(path: str, device=None):
    """A classic-family JSON model dump of either package, by its ``kind``
    tag, on ``device`` (the card when None). An unknown kind is a
    :class:`DataError` listing the known ones."""
    with open(path, encoding="utf-8") as fh:
        payload = json.load(fh)
    kind = payload.get("kind")
    cls = CLASSIC_KINDS.get(kind)
    if cls is None:
        raise DataError(f"{path}: unknown classic model kind {kind!r}; "
                        f"known: {sorted(CLASSIC_KINDS)}")
    return cls.from_payload(payload, where=path, device=device)


__all__ = ["GaussianNB", "LogisticRegression", "LinearSVM", "KMeans",
           "CLASSIC_KINDS", "load_classic_model"]
