"""ETL: results-page HTML → featurized rows → split Datasets (the JAX
package's ``data/pipeline.py``).

Degraded data path: :func:`pipeline_from_url` keeps a stale-while-
revalidate CSV snapshot of the last good featurized rows. Every call
fetches first; on success the snapshot is refreshed, and when the fetch's
retries are exhausted the pipeline serves the snapshot with a warning
instead of failing the run. A permanent failure (4xx) is never masked.
"""

from __future__ import annotations

import os

from euromillioner_tpu_torch.config import FEATURE_COLUMNS, DataConfig
from euromillioner_tpu_torch.data.csvio import read_csv, write_csv
from euromillioner_tpu_torch.data.dataset import Dataset, chronological_split
from euromillioner_tpu_torch.data.features import row_to_features
from euromillioner_tpu_torch.data.parse import extract_table_rows
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils.errors import DataError, FetchError
from euromillioner_tpu_torch.utils.logging_utils import get_logger
from euromillioner_tpu_torch.utils.retry import RetryPolicy

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


def write_cache(path: str, rows: list[list[float]]) -> None:
    """Atomically snapshot featurized rows as fixed-schema CSV. Values
    round-trip exactly, so a cache-served run is bit-identical to a
    fetch-served run over the same draws."""
    fault_point("pipeline.cache_write", path=path)
    tmp = path + ".tmp"
    write_csv(tmp, rows)
    os.replace(tmp, path)


def read_cache(path: str | None) -> list[list[float]] | None:
    """Rows from a snapshot, or None when absent or unreadable (an
    unreadable cache is a miss: the fetch failure that led here is the one
    to surface)."""
    if not path or not os.path.exists(path):
        return None
    try:
        data, _, _ = read_csv(path, label_column=None)
    except (DataError, OSError) as e:
        logger.warning("cache %s unreadable (%s); ignoring it", path, e)
        return None
    return [list(map(float, r)) for r in data]


def pipeline_from_url(cfg: DataConfig | None = None, *,
                      cache_path: str | None = None,
                      policy: RetryPolicy | None = None
                      ) -> tuple[Dataset, Dataset]:
    """Fetch the results page at ``cfg.url`` and run the whole pipeline,
    with stale-while-revalidate degradation. ``cache_path`` (default
    ``cfg.cache_path``) names the CSV snapshot: refreshed after every
    successful fetch, served with a warning when the fetch's retries are
    exhausted. With no usable snapshot, or on a permanent (4xx) failure,
    the ``FetchError`` propagates."""
    from euromillioner_tpu_torch.data.fetch import (fetch_url,
                                                    is_retryable_fetch_error)

    cfg = cfg or DataConfig()
    if cache_path is None:
        cache_path = cfg.cache_path or None
    fault_point("pipeline.from_url", url=cfg.url, cache_path=cache_path)
    fetch_kwargs = {} if policy is None else {"policy": policy}
    try:
        html = fetch_url(cfg.url, **fetch_kwargs)
    except FetchError as e:
        if not is_retryable_fetch_error(e):
            # a moved page (404) or a block (403): stale data would hide
            # the misconfiguration for good
            raise
        rows = read_cache(cache_path)
        if rows is None:
            raise
        logger.warning(
            "fetch failed after retries (%s); serving stale cache %s (%d rows)",
            e, cache_path, len(rows))
        return split_rows(rows, cfg)
    rows = draws_from_html(html, cfg)
    if cache_path:
        try:
            write_cache(cache_path, rows)
        except OSError as e:
            # a failed snapshot refresh must not fail a healthy run
            logger.warning("cache write to %s failed (%s); continuing",
                           cache_path, e)
    return split_rows(rows, cfg)
