"""ETL: fetching (with retry and a stale cache) and parsing the results
page, date featurization, featurized CSV, Dataset with chronological split
(the JAX package's ``data/``)."""

from euromillioner_tpu_torch.data.dataset import Batch, Dataset, chronological_split
from euromillioner_tpu_torch.data.pipeline import (draws_from_html,
                                                   pipeline_from_html,
                                                   pipeline_from_url,
                                                   read_cache, write_cache)

__all__ = ["Batch", "Dataset", "chronological_split", "draws_from_html",
           "pipeline_from_html", "pipeline_from_url", "read_cache",
           "write_cache"]
