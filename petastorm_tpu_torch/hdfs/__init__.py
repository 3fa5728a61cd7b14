"""HDFS namenode resolution (the port's own copy of the resolver half of
``petastorm_tpu/hdfs/``)."""
