"""Dataset converter (the Spark converter's API, pyarrow-backed; the port's
own copy of ``petastorm_tpu/spark``).

The package name is the reference's (``from petastorm_tpu_torch.spark import
make_spark_converter``), but the engine is pyarrow: Arrow tables and pandas
DataFrames convert natively, Spark DataFrames through ``toPandas()``.
"""

from petastorm_tpu_torch.spark.dataset_converter import (
    DatasetConverter,
    SparkDatasetConverter,
    make_spark_converter,
    set_parent_cache_dir_url,
)

__all__ = ["make_spark_converter", "DatasetConverter", "SparkDatasetConverter",
           "set_parent_cache_dir_url"]
