"""HDFS namenode resolution and connection (the port's own copy of
``petastorm_tpu/hdfs/``)."""
