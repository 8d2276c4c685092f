"""Cross-cluster resource search, cache and proxy (ref: pkg/search).

The port's own copy of ``karmada_tpu/search/__init__.py``.

- ResourceRegistry selects which GVKs to cache from which clusters
  (pkg/search/controller.go:79-430 builds per-cluster informer caches).
- MultiClusterCache answers list/get across member caches
  (pkg/search/proxy/store/multi_cluster_cache.go).
- The proxy framework chains plugins cache -> member cluster -> karmada
  control plane (pkg/search/proxy/framework/plugins/, order karmada.go:68-74).
"""

from .registry import ResourceRegistry, ResourceRegistrySpec, SearchController  # noqa: F401
from .proxy import Proxy, ProxyRequest, ProxyResponse  # noqa: F401
