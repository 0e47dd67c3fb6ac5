"""InterPodAffinity failure reasons (upstream v1.26)."""

ERR_EXISTING_ANTI = "node(s) didn't satisfy existing pods' anti-affinity rules"
ERR_AFFINITY = "node(s) didn't match pod affinity rules"
ERR_ANTI_AFFINITY = "node(s) didn't match pod anti-affinity rules"
