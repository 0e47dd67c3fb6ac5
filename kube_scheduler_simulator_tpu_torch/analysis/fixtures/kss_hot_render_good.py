"""KSS-HOT-RENDER good fixture: render-once then share, justified
per-item copies, self-recursive clone helpers, and nested defs that only
LOOK loop-nested."""

import copy
import json


def broadcast_event(subscribers, obj):
    # render ONCE, share the bytes with every consumer
    line = json.dumps({"type": "MODIFIED", "object": obj}) + "\n"
    for sub in subscribers:
        sub.write(line)


def _clone(o):
    # self-recursion through its own comprehension IS the clone helper
    if isinstance(o, dict):
        return {k: _clone(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_clone(v) for v in o]
    return copy.deepcopy(o)


def dump_snapshot(buckets):
    # hot-render-ok: debug/snapshot surface, never on the commit path
    return {k: [_clone(o) for o in b] for k, b in buckets.items()}


def make_writers(items):
    writers = []
    for item in items:
        # a nested def's body runs when CALLED — not per iteration of
        # the loop that encloses its definition site
        def write(obj=item):
            return json.dumps(obj)

        writers.append(write)
    return writers
