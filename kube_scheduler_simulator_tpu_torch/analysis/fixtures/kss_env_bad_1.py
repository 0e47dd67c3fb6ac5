"""KSS-ENV bad fixture 1: an undocumented read and a ghost knob.

The fixture-scoped "documentation" is the ``documents:`` line below —
it plays the role docs/environment-variables.md plays on the live tree.
"""

# documents: KSS_FIXTURE_DOCUMENTED KSS_FIXTURE_GHOST  # expect-finding

import os


def load_config():
    # read but not documented anywhere in the fixture set:
    raw = os.environ.get("KSS_FIXTURE_UNDOCUMENTED")  # expect-finding
    return raw
