"""KSS-HOT-RENDER bad fixture 1: per-object serialize inside the fan-out
loop — the exact O(consumers x mutations) shape the wire cache removed."""

import copy
import json


def broadcast_event(subscribers, obj):
    for sub in subscribers:
        line = json.dumps({"type": "MODIFIED", "object": obj})  # expect-finding
        sub.write(line + "\n")


def snapshot_items(bucket):
    return [copy.deepcopy(o) for o in bucket.values()]  # expect-finding
