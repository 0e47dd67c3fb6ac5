"""KSS-HOT-RENDER bad fixture 2: the store-shaped variants — a per-event
``_clone`` in the emit loop and a while-drain that re-dumps per item."""

import json


def _clone(o):
    return json.loads(json.dumps(o))


def emit_all(events, subscribers):
    for ev in events:
        for sub in subscribers:
            sub(_clone(ev))  # expect-finding


def drain(queue):
    out = []
    while queue:
        item = queue.pop()
        out.append(json.dumps(item))  # expect-finding
    return out
