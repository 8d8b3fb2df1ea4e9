"""ETL: results-page HTML → featurized rows → split Datasets (the JAX
package's ``data/pipeline.py``, from a page already on disk; fetching the
live page, with its retry and stale-cache path, is not ported yet)."""

from __future__ import annotations

from euromillioner_tpu_torch.config import FEATURE_COLUMNS, DataConfig
from euromillioner_tpu_torch.data.dataset import Dataset, chronological_split
from euromillioner_tpu_torch.data.features import row_to_features
from euromillioner_tpu_torch.data.parse import extract_table_rows
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("data.pipeline")


def draws_from_html(html: str, cfg: DataConfig | None = None
                    ) -> list[list[float]]:
    """HTML page → list of 11-feature rows (info row dropped)."""
    cfg = cfg or DataConfig()
    cells = extract_table_rows(html, cfg.table_class, drop_info_row=True)
    rows = [row_to_features(r, cfg.date_format) for r in cells]
    logger.info("parsed %d draw rows from results table", len(rows))
    return rows


def split_rows(rows: list[list[float]], cfg: DataConfig
               ) -> tuple[Dataset, Dataset]:
    """Featurized rows → (train, validation): chronological
    ``train_percent`` split, label = column ``label_column``."""
    ds = Dataset.from_rows(
        rows, label_column=cfg.label_column, feature_names=list(FEATURE_COLUMNS))
    train, val = chronological_split(ds, cfg.train_percent)
    logger.info("split %d rows → train=%d validation=%d", len(ds), len(train), len(val))
    return train, val


def pipeline_from_html(html: str, cfg: DataConfig | None = None
                       ) -> tuple[Dataset, Dataset]:
    """HTML → (train, validation) Datasets."""
    cfg = cfg or DataConfig()
    return split_rows(draws_from_html(html, cfg), cfg)
