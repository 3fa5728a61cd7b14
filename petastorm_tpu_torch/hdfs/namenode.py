"""HDFS HA-namenode resolution and connection with failover (the port's
own copy of ``petastorm_tpu/hdfs/namenode.py``).

:class:`HdfsNamenodeResolver` parses ``core-site.xml`` / ``hdfs-site.xml``
found through ``$HADOOP_CONF_DIR``, ``$HADOOP_HOME``, ``$HADOOP_PREFIX`` or
``$HADOOP_INSTALL`` and resolves an HA nameservice's logical name to its
namenodes' ``host:port`` addresses. :class:`HdfsConnector` connects to them
through ``pyarrow.fs.HadoopFileSystem`` (pyarrow's libhdfs bridge), trying
the namenodes in order; :func:`connect_hdfs` does both for an ``hdfs://``
URL.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET


class HdfsConnectError(IOError):
    pass


class MaxFailoversExceeded(RuntimeError):
    def __init__(self, failed_exceptions, max_failover_attempts, func_name):
        self.failed_exceptions = failed_exceptions
        self.max_failover_attempts = max_failover_attempts
        self.__name__ = func_name
        super().__init__(
            f"Failover attempts exceeded maximum ({max_failover_attempts}) for "
            f"{func_name}; failures: {failed_exceptions}")


class HdfsNamenodeResolver:
    """Resolves HDFS logical nameservices through Hadoop client configs;
    ``hadoop_configuration`` (a ``{name: value}`` dict) replaces the files
    found from the environment."""

    def __init__(self, hadoop_configuration=None):
        self._hadoop_env = None
        self._hadoop_path = None
        if hadoop_configuration is None:
            hadoop_configuration = self._load_site_configs()
        self._hadoop_configuration = hadoop_configuration or {}

    def _load_site_configs(self):
        """Locate and parse core-site.xml and hdfs-site.xml, if findable."""
        conf_dir = None
        for env, subpath in (("HADOOP_CONF_DIR", ""), ("HADOOP_HOME", "etc/hadoop"),
                             ("HADOOP_PREFIX", "etc/hadoop"),
                             ("HADOOP_INSTALL", "hadoop/conf")):
            base = os.environ.get(env)
            if base:
                candidate = os.path.join(base, subpath) if subpath else base
                if os.path.isdir(candidate):
                    self._hadoop_env, self._hadoop_path, conf_dir = env, base, candidate
                    break
        if conf_dir is None:
            return {}
        config = {}
        for name in ("core-site.xml", "hdfs-site.xml"):
            path = os.path.join(conf_dir, name)
            if os.path.isfile(path):
                config.update(_parse_hadoop_xml(path))
        return config

    @property
    def hadoop_configuration(self):
        return self._hadoop_configuration

    def resolve_default_hdfs_service(self):
        """``(nameservice, [namenode host:port, ...])`` of ``fs.defaultFS``."""
        default_fs = self._hadoop_configuration.get("fs.defaultFS", "")
        if not default_fs.startswith("hdfs://"):
            raise HdfsConnectError(
                f"Hadoop config does not define an HDFS fs.defaultFS (got {default_fs!r}); "
                "set HADOOP_CONF_DIR/HADOOP_HOME correctly")
        nameservice = default_fs[len("hdfs://"):].split("/")[0]
        return nameservice, self.resolve_hdfs_name_service(nameservice)

    def resolve_hdfs_name_service(self, namespec):
        """A logical nameservice's namenode addresses. ``host:port`` is
        returned as is; with no configuration at all the name is returned
        for DNS to try; an unknown nameservice raises
        :class:`HdfsConnectError`."""
        if ":" in namespec:
            return [namespec]
        conf = self._hadoop_configuration
        nameservices = conf.get("dfs.nameservices", "")
        if namespec not in [s.strip() for s in nameservices.split(",") if s]:
            if not conf:
                return [namespec]
            raise HdfsConnectError(
                f"Unknown HDFS nameservice {namespec!r}; dfs.nameservices={nameservices!r}")
        namenodes = []
        for ha_id in [s.strip() for s in conf.get(f"dfs.ha.namenodes.{namespec}", "").split(",")
                      if s.strip()]:
            address = conf.get(f"dfs.namenode.rpc-address.{namespec}.{ha_id}")
            if address:
                namenodes.append(address)
        if not namenodes:
            raise HdfsConnectError(
                f"Nameservice {namespec!r} has no resolvable namenode rpc-addresses")
        return namenodes


class HdfsConnector:
    """Connects to HDFS namenodes with failover (pyarrow HadoopFileSystem,
    looked up at call time)."""

    MAX_NAMENODES = 2

    @classmethod
    def hdfs_connect_namenode(cls, parsed_url, driver="libhdfs", user=None):
        """One connection attempt to ``parsed_url.hostname:port``; ``driver``
        is accepted and unused (pyarrow has the one libhdfs bridge)."""
        import pyarrow.fs as pafs

        host = parsed_url.hostname or "default"
        port = parsed_url.port or 8020
        try:
            return pafs.HadoopFileSystem(host=host, port=port, user=user)
        except Exception as exc:
            raise HdfsConnectError(
                f"Failed to connect to HDFS namenode {host}:{port}: {exc}") from exc

    @classmethod
    def connect_to_either_namenode(cls, namenodes, user=None):
        """Try the first :attr:`MAX_NAMENODES` namenodes in order; raise
        :class:`MaxFailoversExceeded` with every failure if all fail."""
        import pyarrow.fs as pafs

        failures = []
        for address in namenodes[:cls.MAX_NAMENODES]:
            host, _, port = address.partition(":")
            try:
                return pafs.HadoopFileSystem(host=host, port=int(port) if port else 8020,
                                             user=user)
            except Exception as exc:  # noqa: BLE001 - collected for the failover error
                failures.append(exc)
        raise MaxFailoversExceeded(failures, cls.MAX_NAMENODES, "connect_to_either_namenode")


def connect_hdfs(parsed_url, user=None, hadoop_configuration=None):
    """Resolve and connect an ``hdfs://`` URL: ``(filesystem, path)``. A
    ``host:port`` or dotted host is one namenode; a bare name is a
    nameservice, and no host is ``fs.defaultFS``'s, each tried with
    failover. ``hadoop_configuration`` replaces the files found from the
    environment."""
    resolver = HdfsNamenodeResolver(hadoop_configuration)
    if parsed_url.hostname:
        if parsed_url.port or "." in parsed_url.hostname:
            fs = HdfsConnector.hdfs_connect_namenode(parsed_url, user=user)
        else:
            namenodes = resolver.resolve_hdfs_name_service(parsed_url.hostname)
            fs = HdfsConnector.connect_to_either_namenode(namenodes, user=user)
    else:
        _, namenodes = resolver.resolve_default_hdfs_service()
        fs = HdfsConnector.connect_to_either_namenode(namenodes, user=user)
    return fs, parsed_url.path


def _parse_hadoop_xml(path):
    """One Hadoop site XML file as a flat ``{name: value}`` dict."""
    config = {}
    for prop in ET.parse(path).getroot().iter("property"):
        name, value = prop.findtext("name"), prop.findtext("value")
        if name is not None and value is not None:
            config[name.strip()] = value.strip()
    return config
