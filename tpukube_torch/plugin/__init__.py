"""Node agent (L3): the deviceplugin/v1beta1 server, its health watch and
the kubelet peers. Importing the package loads no ``grpc``: only the gRPC
transport's calls (``DevicePluginServer.start``/``register_with_kubelet``,
``FakeKubelet``) and ``plugin.stubs`` do."""

from tpukube_torch.plugin.server import (  # noqa: F401
    DevicePluginServer,
    HealthWatcher,
    KubeletSessionWatcher,
    PluginRpcError,
)
from tpukube_torch.plugin.fake_kubelet import (  # noqa: F401
    FakeKubelet,
    InProcessKubelet,
    make_kubelet,
)
