"""Typed gRPC serving of the port (a copy of
``tests/test_serve_grpc_typed.py`` over the port's runtime): a
protoc-generated-style service registered on the proxy via
grpc_servicer_functions, with typed request/response
messages enforced by the service's own (de)serializers (reference:
serve/_private/proxy.py:538 gRPCProxy + grpc_options.
grpc_servicer_functions; VERDICT r4 weak #5).

Hermetic: the "generated" module is hand-written with the exact
surface protoc emits (message FromString/SerializeToString + an
add_XServicer_to_server that builds typed method handlers), so no
protoc run or .proto file is needed."""

import os
import socket
import sys
import textwrap

import pytest

# The fake generated module must be importable in the PROXY ACTOR's
# worker process: write it before the cluster starts and extend
# PYTHONPATH (child_env propagates it to spawned workers).
_MODULE = textwrap.dedent(
    '''
    """Hand-written stand-in for protoc output (module surface only)."""
    import grpc
    import json


    class PredictRequest:
        def __init__(self, x=0.0):
            self.x = float(x)

        def SerializeToString(self):
            return json.dumps({"x": self.x}).encode()

        @classmethod
        def FromString(cls, data):
            return cls(**json.loads(data))


    class PredictResponse:
        def __init__(self, y=0.0):
            self.y = float(y)

        def SerializeToString(self):
            return json.dumps({"y": self.y}).encode()

        @classmethod
        def FromString(cls, data):
            return cls(**json.loads(data))


    def add_PredictorServicer_to_server(servicer, server):
        rpc_method_handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                servicer.Predict,
                request_deserializer=PredictRequest.FromString,
                response_serializer=PredictResponse.SerializeToString,
            ),
        }
        handler = grpc.method_handlers_generic_handler(
            "demo.Predictor", rpc_method_handlers
        )
        server.add_generic_rpc_handlers((handler,))
    '''
)


@pytest.fixture(scope="module")
def typed_cluster(tmp_path_factory):
    import ray_tpu_torch

    d = tmp_path_factory.mktemp("typed_grpc_mod")
    (d / "port_demo_pb2_grpc.py").write_text(_MODULE)
    sys.path.insert(0, str(d))
    old_pp = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = str(d) + (os.pathsep + old_pp if old_pp else "")
    # many clusters share the machine under xdist: no 2 GiB arena
    # prefault, and no memory monitor killing this test's workers
    saved = {k: os.environ.get(k) for k in ("RAY_TPU_TORCH_arena_prefault_bytes",
                                            "RAY_TPU_TORCH_memory_monitor_enabled")}
    os.environ.update(dict.fromkeys(saved, "0"))
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    from ray_tpu_torch import serve

    serve.shutdown()
    ray_tpu_torch.shutdown()
    os.environ["PYTHONPATH"] = old_pp
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    sys.path.remove(str(d))


def test_typed_grpc_service_routes_messages(typed_cluster):
    import grpc

    import port_demo_pb2_grpc
    from ray_tpu_torch import serve

    @serve.deployment(name="Doubler")
    class Doubler:
        def Predict(self, req):
            # typed contract: receives PredictRequest, returns PredictResponse
            assert isinstance(req, port_demo_pb2_grpc.PredictRequest), type(req)
            return port_demo_pb2_grpc.PredictResponse(y=req.x * 2)

    with socket.socket() as sock:  # the JAX package's test binds 19544
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    serve.run(
        Doubler.bind(),
        grpc_port=port,
        grpc_servicer_functions=["port_demo_pb2_grpc.add_PredictorServicer_to_server"],
    )

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    predict = channel.unary_unary(
        "/demo.Predictor/Predict",
        request_serializer=port_demo_pb2_grpc.PredictRequest.SerializeToString,
        response_deserializer=port_demo_pb2_grpc.PredictResponse.FromString,
    )
    resp = predict(
        port_demo_pb2_grpc.PredictRequest(x=21.0),
        metadata=(("deployment", "Doubler"),),
        timeout=30,
    )
    assert resp.y == 42.0

    # missing deployment metadata is a typed INVALID_ARGUMENT, not a hang
    with pytest.raises(grpc.RpcError) as err:
        predict(port_demo_pb2_grpc.PredictRequest(x=1.0), timeout=10)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    channel.close()
