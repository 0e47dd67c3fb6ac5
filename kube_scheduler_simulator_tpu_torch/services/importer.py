"""Cluster-resource importer: one-shot import of an external cluster.

Rebuild of the reference's clusterresourceimporter (reference
simulator/clusterresourceimporter/importer.go:17-60): Snap the external
cluster, convert, and Load into the simulator with errors ignored and the
scheduler configuration left untouched.

The external source is injected as any object with a ``snap()`` method
returning the ResourcesForSnap shape: another SnapshotService (simulator →
simulator), a kubeconfig-backed client adapter, or a file loader.
"""

from __future__ import annotations

from typing import Any, Protocol


class SnapSource(Protocol):
    def snap(self) -> dict: ...


class ClusterResourceImporter:
    def __init__(self, export_service: SnapSource, import_service: Any):
        """``export_service``: where resources come from (external cluster);
        ``import_service``: the simulator's SnapshotService."""
        self.export_service = export_service
        self.import_service = import_service

    def import_cluster_resources(self) -> None:
        resources = self.export_service.snap()
        # IgnoreErr + IgnoreSchedulerConfiguration (reference importer.go:44-60)
        self.import_service.load(resources, ignore_err=True, ignore_scheduler_configuration=True)


class FileSnapSource:
    """Load a ResourcesForSnap JSON/YAML file as an import source."""

    def __init__(self, path: str):
        self.path = path

    def snap(self) -> dict:
        import json

        with open(self.path) as f:
            text = f.read()
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            import yaml  # type: ignore[import-untyped]

            return yaml.safe_load(text)


class KubeClusterSnapSource:
    """Snap a LIVE cluster into the ResourcesForSnap shape (reference
    clusterresourceimporter/importer.go:44-60 lists the 7 kinds from a
    kubeconfig-backed client-go clientset).

    The kube API is reached either through an injected client object
    exposing ``list_kind(api_path) -> {"items": [...]}`` (tests use a
    stub; the ``kubernetes`` package's CoreV1Api can be adapted in one
    lambda) or, by default, plain HTTPS calls built from a kubeconfig
    file — no kubernetes-client dependency, mirroring this build's
    no-extra-installs constraint."""

    # json key → kube API list path (cluster-wide)
    KIND_PATHS = (
        ("pods", "/api/v1/pods"),
        ("nodes", "/api/v1/nodes"),
        ("pvs", "/api/v1/persistentvolumes"),
        ("pvcs", "/api/v1/persistentvolumeclaims"),
        ("storageClasses", "/apis/storage.k8s.io/v1/storageclasses"),
        ("priorityClasses", "/apis/scheduling.k8s.io/v1/priorityclasses"),
        ("namespaces", "/api/v1/namespaces"),
    )

    def __init__(self, client: Any = None, kubeconfig: "str | None" = None):
        if client is None:
            client = KubeConfigClient(kubeconfig)
        self.client = client

    def snap(self) -> dict:
        out: dict = {}
        for json_key, path in self.KIND_PATHS:
            body = self.client.list_kind(path) or {}
            items = body.get("items") or []
            for it in items:
                # list responses omit apiVersion/kind on items; drop
                # cluster-managed fields that would fight the store
                (it.get("metadata") or {}).pop("managedFields", None)
            out[json_key] = items
        # a live cluster's scheduler config is not readable via the API
        out["schedulerConfig"] = None
        return out


class KubeConfigClient:
    """Minimal kubeconfig-driven kube API lister (stdlib only): supports
    token and client-certificate auth, which covers kubeadm/kind/GKE
    token configs.  Only what the importer needs — list calls."""

    def __init__(self, kubeconfig: "str | None" = None):
        import os

        path = kubeconfig or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
        with open(path) as f:
            text = f.read()
        try:
            import json

            cfg = json.loads(text)
        except Exception:
            import yaml  # type: ignore[import-untyped]

            cfg = yaml.safe_load(text)
        ctx_name = cfg.get("current-context")
        ctx = next(c["context"] for c in cfg["contexts"] if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg["clusters"] if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in cfg["users"] if u["name"] == ctx["user"])
        self.server = cluster["server"].rstrip("/")
        self._ssl_ctx = self._build_ssl(cluster, user)
        self.token = user.get("token")

    @staticmethod
    def _build_ssl(cluster: dict, user: dict):
        import base64
        import ssl
        import tempfile

        ctx = ssl.create_default_context()
        if cluster.get("insecure-skip-tls-verify"):
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif cluster.get("certificate-authority-data"):
            ctx.load_verify_locations(
                cadata=base64.b64decode(cluster["certificate-authority-data"]).decode()
            )
        elif cluster.get("certificate-authority"):
            ctx.load_verify_locations(cafile=cluster["certificate-authority"])
        cert_data = user.get("client-certificate-data")
        key_data = user.get("client-key-data")
        if cert_data and key_data:
            # ssl wants files; write the decoded pair to a temp pem and
            # remove it immediately after the chain is loaded (it holds
            # the client's PRIVATE KEY)
            import os

            pem = tempfile.NamedTemporaryFile("w", suffix=".pem", delete=False)
            try:
                pem.write(base64.b64decode(cert_data).decode())
                pem.write("\n")
                pem.write(base64.b64decode(key_data).decode())
                pem.flush()
                ctx.load_cert_chain(pem.name)
            finally:
                pem.close()
                os.unlink(pem.name)
        elif user.get("client-certificate") and user.get("client-key"):
            ctx.load_cert_chain(user["client-certificate"], keyfile=user["client-key"])
        return ctx

    def list_kind(self, path: str) -> dict:
        import json
        import urllib.request

        req = urllib.request.Request(self.server + path)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(req, timeout=30, context=self._ssl_ctx) as resp:
            return json.loads(resp.read())
