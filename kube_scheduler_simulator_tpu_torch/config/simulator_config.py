"""SimulatorConfiguration: env-first + ./config.yaml loading.

Rebuild of the reference's config layer (reference
simulator/config/config.go:51-281 and config/v1alpha1/types.go:25-65):
every knob can come from the v1alpha1 YAML file, and environment variables
take precedence (the reference's get* helpers each check an env var first).

Env vars honored (reference config.go:127-257): PORT, KUBE_API_PORT,
KUBE_API_HOST, EXTERNAL_SCHEDULER_ENABLED, KUBE_SCHEDULER_SIMULATOR_ETCD_URL,
CORS_ALLOWED_ORIGIN_LIST, KUBE_SCHEDULER_CONFIG_PATH,
EXTERNAL_IMPORT_ENABLED.
"""

from __future__ import annotations

import os
from typing import Any

Obj = dict[str, Any]

DEFAULT_FILE = "config.yaml"


class Config:
    """The resolved simulator configuration (reference Config struct)."""

    def __init__(
        self,
        port: int = 1212,
        etcd_url: str = "",
        cors_allowed_origin_list: "list[str] | None" = None,
        kube_api_host: str = "127.0.0.1",
        kube_api_port: int = 3131,
        initial_scheduler_cfg: "Obj | None" = None,
        external_import_enabled: bool = False,
        kubeconfig: str = "",
        external_scheduler_enabled: bool = False,
        autoscale: str = "off",
        autoscaler_expander: str = "least-waste",
        autoscaler_scale_down_threshold: float = 0.5,
        autoscaler_scale_down_rounds: int = 3,
    ):
        self.port = port
        self.etcd_url = etcd_url
        self.cors_allowed_origin_list = cors_allowed_origin_list or []
        self.kube_api_host = kube_api_host
        self.kube_api_port = kube_api_port
        self.initial_scheduler_cfg = initial_scheduler_cfg
        self.external_import_enabled = external_import_enabled
        self.kubeconfig = kubeconfig
        self.external_scheduler_enabled = external_scheduler_enabled
        # capacity engine (docs/autoscaler.md): off | on | scenario
        self.autoscale = autoscale
        self.autoscaler_expander = autoscaler_expander
        self.autoscaler_scale_down_threshold = autoscaler_scale_down_threshold
        self.autoscaler_scale_down_rounds = autoscaler_scale_down_rounds


def load_yaml_config(path: "str | None" = None) -> Obj:
    """LoadYamlConfig analog (config.go:102-123): missing file → defaults.
    PyYAML is imported only to read a file that exists."""
    path = path or DEFAULT_FILE
    if not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: SimulatorConfiguration must be a mapping")
    return data


def new_config(config_path: "str | None" = None) -> Config:
    """NewConfig analog (config.go:51-99): YAML file + env precedence."""
    y = load_yaml_config(config_path)

    def env_int(name: str, yaml_key: str, default: int) -> int:
        v = os.environ.get(name)
        if v:
            try:
                return int(v)
            except ValueError as e:
                raise ValueError(f"env {name} must be an integer: {v!r}") from e
        return int(y.get(yaml_key) or default)

    def env_str(name: str, yaml_key: str, default: str) -> str:
        return os.environ.get(name) or str(y.get(yaml_key) or default)

    def env_bool(name: str, yaml_key: str, default: bool) -> bool:
        v = os.environ.get(name)
        if v:
            return v.lower() in ("1", "true", "yes")
        yv = y.get(yaml_key)
        return default if yv is None else bool(yv)

    cors = os.environ.get("CORS_ALLOWED_ORIGIN_LIST")
    cors_list = [c for c in cors.split(",") if c] if cors else list(y.get("corsAllowedOriginList") or [])

    sched_cfg_path = env_str("KUBE_SCHEDULER_CONFIG_PATH", "kubeSchedulerConfigPath", "")
    initial_cfg: "Obj | None" = None
    if sched_cfg_path:
        import yaml

        with open(sched_cfg_path) as f:
            initial_cfg = yaml.safe_load(f) or None

    def env_float(name: str, yaml_key: str, default: float) -> float:
        v = os.environ.get(name)
        if v:
            try:
                return float(v)
            except ValueError as e:
                raise ValueError(f"env {name} must be a number: {v!r}") from e
        yv = y.get(yaml_key)
        return default if yv is None else float(yv)

    autoscale = env_str("AUTOSCALE_MODE", "autoscale", "off")
    if autoscale not in ("off", "on", "scenario"):
        raise ValueError(f"AUTOSCALE_MODE must be off|on|scenario, got {autoscale!r}")
    expander = env_str("AUTOSCALE_EXPANDER", "autoscalerExpander", "least-waste")
    # mirror autoscaler/expander.EXPANDERS without importing the package
    # (it pulls in the estimator and its kernels, which config loading
    # must not)
    if expander not in ("least-waste", "most-pods", "priority"):
        raise ValueError(
            f"AUTOSCALE_EXPANDER must be least-waste|most-pods|priority, got {expander!r}"
        )

    return Config(
        port=env_int("PORT", "port", 1212),
        etcd_url=env_str("KUBE_SCHEDULER_SIMULATOR_ETCD_URL", "etcdURL", ""),
        cors_allowed_origin_list=cors_list,
        kube_api_host=env_str("KUBE_API_HOST", "kubeApiHost", "127.0.0.1"),
        kube_api_port=env_int("KUBE_API_PORT", "kubeApiPort", 3131),
        initial_scheduler_cfg=initial_cfg,
        external_import_enabled=env_bool("EXTERNAL_IMPORT_ENABLED", "externalImportEnabled", False),
        kubeconfig=env_str("KUBECONFIG", "kubeConfig", ""),
        external_scheduler_enabled=env_bool(
            "EXTERNAL_SCHEDULER_ENABLED", "externalSchedulerEnabled", False
        ),
        autoscale=autoscale,
        autoscaler_expander=expander,
        autoscaler_scale_down_threshold=env_float(
            "AUTOSCALE_SCALE_DOWN_THRESHOLD", "autoscalerScaleDownUtilizationThreshold", 0.5
        ),
        autoscaler_scale_down_rounds=env_int(
            "AUTOSCALE_SCALE_DOWN_ROUNDS", "autoscalerScaleDownUnneededRounds", 3
        ),
    )
