"""Result annotation keys.

Byte-identical to the reference's keys (reference
simulator/scheduler/plugin/annotation/annotation.go:3-31,
simulator/scheduler/extender/annotation/annotation.go:3-12,
simulator/scheduler/storereflector/annotation.go:4).
"""

PREFILTER_STATUS_RESULT = "scheduler-simulator/prefilter-result-status"
PREFILTER_RESULT = "scheduler-simulator/prefilter-result"
FILTER_RESULT = "scheduler-simulator/filter-result"
POSTFILTER_RESULT = "scheduler-simulator/postfilter-result"
PRESCORE_RESULT = "scheduler-simulator/prescore-result"
SCORE_RESULT = "scheduler-simulator/score-result"
FINALSCORE_RESULT = "scheduler-simulator/finalscore-result"
RESERVE_RESULT = "scheduler-simulator/reserve-result"
PERMIT_STATUS_RESULT = "scheduler-simulator/permit-result"
PERMIT_TIMEOUT_RESULT = "scheduler-simulator/permit-result-timeout"
PREBIND_RESULT = "scheduler-simulator/prebind-result"
BIND_RESULT = "scheduler-simulator/bind-result"
SELECTED_NODE = "scheduler-simulator/selected-node"

EXTENDER_FILTER_RESULT = "scheduler-simulator/extender-filter-result"
EXTENDER_PRIORITIZE_RESULT = "scheduler-simulator/extender-prioritize-result"
EXTENDER_PREEMPT_RESULT = "scheduler-simulator/extender-preempt-result"
EXTENDER_BIND_RESULT = "scheduler-simulator/extender-bind-result"

RESULT_HISTORY = "scheduler-simulator/result-history"
