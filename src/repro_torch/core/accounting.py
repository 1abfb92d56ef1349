"""Cost/time accounting — the arithmetic behind Eq. 1 and Table 1.

All units are decimal (1 GB = 1e9 bytes), matching the paper's numbers
(157.3 GB ImageNet at 500 KB/s = 87.39 h checks out only in decimal units).
The paper's Table-1 "m" in the AT-speed column is a typo for hours
(8.73 GB / 34 MB/s = 0.071 h); we reproduce hours.
"""

from __future__ import annotations

import dataclasses

GB = 1e9
TB = 1e12
MB = 1e6
KB = 1e3
HOUR = 3600.0

#: US Amazon S3 egress price the paper assumes (footnote 3).
S3_PRICE_PER_GB = 0.0275

#: Paper constants (Section 2).
REDDIT_SIZE_GB = 160.68
REDDIT_SEEDER_UPLOADED_GB = 366.68
REDDIT_TOTAL_DOWNLOADED_TB = 15.43
REDDIT_DOWNLOADS = 96
PAPER_UD_RATIO = 42.067
HTTP_SPEED_BPS = 500 * KB     # university-mirror observation
AT_SPEED_BPS = 34 * MB        # swarm observation

#: Table 1 datasets: name -> size in GB (upload column / 100 downloads).
TABLE1_DATASETS = {
    "whale": 8.73,
    "diabetes": 82.2,
    "imagenet": 157.3,
}


@dataclasses.dataclass(frozen=True)
class CostModel:
    price_per_gb: float = S3_PRICE_PER_GB

    def egress_cost(self, nbytes: float) -> float:
        return nbytes / GB * self.price_per_gb


def ud_ratio(total_downloaded_bytes: float, origin_uploaded_bytes: float) -> float:
    """Eq. 1. For the paper's ledger: 15.43 TB / 366.68 GB = 42.067."""
    if origin_uploaded_bytes <= 0:
        return float("inf") if total_downloaded_bytes else 0.0
    return total_downloaded_bytes / origin_uploaded_bytes


@dataclasses.dataclass(frozen=True)
class Projection:
    """One Table-1 row."""

    name: str
    http_upload_bytes: float
    at_upload_bytes: float
    cost_savings: float
    http_hours: float
    at_hours: float
    time_savings_hours: float


def project_row(
    name: str,
    size_bytes: float,
    n_downloads: int,
    measured_ud: float,
    http_speed_bps: float = HTTP_SPEED_BPS,
    at_speed_bps: float = AT_SPEED_BPS,
    cost: CostModel = CostModel(),
) -> Projection:
    """Project origin bandwidth and download time at a measured U/D ratio.

    HTTP: the origin uploads every byte (N x size). AT: the origin uploads
    the same total divided by the U/D amplification. Times are single-client
    wall clock at the measured speeds — exactly the paper's method.
    """
    http_up = float(n_downloads) * size_bytes
    at_up = http_up / measured_ud
    return Projection(
        name=name,
        http_upload_bytes=http_up,
        at_upload_bytes=at_up,
        cost_savings=cost.egress_cost(http_up - at_up),
        http_hours=size_bytes / http_speed_bps / HOUR,
        at_hours=size_bytes / at_speed_bps / HOUR,
        time_savings_hours=(size_bytes / http_speed_bps - size_bytes / at_speed_bps)
        / HOUR,
    )


def paper_table1(measured_ud: float = PAPER_UD_RATIO) -> list[Projection]:
    return [
        project_row(name, gb * GB, 100, measured_ud)
        for name, gb in TABLE1_DATASETS.items()
    ]


def reddit_case_study() -> dict[str, float]:
    """The paper's §2 ledger math, from its published constants."""
    ud = ud_ratio(REDDIT_TOTAL_DOWNLOADED_TB * TB, REDDIT_SEEDER_UPLOADED_GB * GB)
    cost = CostModel()
    per_download = cost.egress_cost(REDDIT_SIZE_GB * GB)
    return {
        "ud_ratio": ud,
        "cost_per_download": per_download,                       # $4.42
        "http_bill": REDDIT_DOWNLOADS * per_download,            # $424.32
        "at_bill": cost.egress_cost(REDDIT_SEEDER_UPLOADED_GB * GB),  # $10.09
    }
