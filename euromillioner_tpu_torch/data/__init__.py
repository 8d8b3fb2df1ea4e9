"""ETL: results-page parsing, date featurization, featurized CSV, Dataset
with chronological split (the JAX package's ``data/``, without fetching)."""

from euromillioner_tpu_torch.data.dataset import Batch, Dataset, chronological_split
from euromillioner_tpu_torch.data.pipeline import draws_from_html, pipeline_from_html

__all__ = ["Batch", "Dataset", "chronological_split", "draws_from_html",
           "pipeline_from_html"]
