"""GCS listing helpers (the port's own copy of
``petastorm_tpu/gcsfs_helpers/``)."""

from petastorm_tpu_torch.gcsfs_helpers.gcsfs_fast_list import (  # noqa: F401
    FastListingFilesystem,
    build_dircache,
    fast_list,
    seed_listing_cache,
    warm_gcs_listing,
)

__all__ = ["FastListingFilesystem", "build_dircache", "fast_list", "seed_listing_cache",
           "warm_gcs_listing"]
