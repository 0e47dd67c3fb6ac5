"""PodTopologySpread failure reasons (upstream v1.26)."""

ERR_REASON = "node(s) didn't match pod topology spread constraints"
ERR_REASON_LABEL = ERR_REASON + " (missing required label)"
