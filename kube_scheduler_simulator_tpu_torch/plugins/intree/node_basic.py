"""NodeName, NodeUnschedulable, NodePorts: failure reasons and the host-port
helpers the encoder reads (upstream v1.26)."""

from __future__ import annotations

from typing import Any

Obj = dict[str, Any]

NODE_NAME_ERR = "node(s) didn't match the requested node name"
NODE_UNSCHEDULABLE_ERR = "node(s) were unschedulable"
NODE_PORTS_ERR = "node(s) didn't have free ports for the requested pod ports"


def _host_ports(pod: Obj) -> list[tuple[str, str, int]]:
    """(protocol, hostIP, hostPort) triples a pod wants on the host."""
    out = []
    for c in (pod.get("spec") or {}).get("containers") or []:
        for p in c.get("ports") or []:
            hp = p.get("hostPort")
            if hp:
                out.append((p.get("protocol") or "TCP", p.get("hostIP") or "0.0.0.0", int(hp)))
    return out


def _ports_conflict(want: tuple[str, str, int], used: tuple[str, str, int]) -> bool:
    """Upstream schedutil.HostPortInfo conflict: same port+protocol and
    overlapping IP (0.0.0.0 overlaps everything)."""
    wproto, wip, wport = want
    uproto, uip, uport = used
    if wport != uport or wproto != uproto:
        return False
    return wip == uip or wip == "0.0.0.0" or uip == "0.0.0.0"
