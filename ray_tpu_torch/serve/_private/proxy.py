"""HTTP proxy actor (reference: serve/_private/proxy.py:1135 ProxyActor,
HTTPProxy :759 — uvicorn/ASGI there; aiohttp here): routes requests by
route_prefix to deployment handles.

Port of ``ray_tpu/serve/_private/proxy.py``: the same routes, chunked
token stream, disconnect-cancel, 503 + Retry-After shed mapping and
per-tenant token buckets.  It imports no torch: replies and stream items
are plain JSON-able values."""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class ProxyActor:
    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._handles: Dict[str, Any] = {}
        self._routes: Dict[str, str] = {}  # route_prefix -> deployment name
        # deployment -> proxy-enforced config (load-shedding bound)
        self._route_cfg: Dict[str, dict] = {}
        # deployment -> requests in flight through this proxy; past the
        # deployment's max_queued_requests new work is SHED (503 +
        # Retry-After) so overload degrades instead of queueing unboundedly
        self._inflight: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        # deployment -> TenantBuckets (token-rate quota admission, built
        # from the route table's tenant_quotas; rebuilt only when the
        # quota table actually changes so bucket state survives pushes)
        self._tenant_buckets: Dict[str, Any] = {}
        # deployment -> tenant label -> quota-shed count (/-/stats)
        self._shed_tenant: Dict[str, Dict[str, int]] = {}
        self._started = False
        # Dedicated pool for routing: pick() can block up to 30s during a
        # cold start — on the shared default executor a burst of such
        # requests would starve _await_ref of threads and stall responses
        # for healthy deployments too.
        from concurrent.futures import ThreadPoolExecutor

        self._route_pool = ThreadPoolExecutor(max_workers=64, thread_name_prefix="serve-route")

    async def _start(self):
        from aiohttp import web

        import ray_tpu_torch
        from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME, LP_ROUTE_TABLE
        from ray_tpu_torch.serve._private.long_poll import LongPollClient

        self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, "serve")
        # route-table changes PUSH via long-poll (one RTT after deploy);
        # the lazy refresh below remains a fallback for cold misses
        self._long_poll = LongPollClient(
            self._controller, {LP_ROUTE_TABLE: self._on_routes_pushed}
        )

        app = web.Application()
        app.router.add_route("*", "/-/routes", self._routes_endpoint)
        app.router.add_route("*", "/-/healthz", self._healthz)
        app.router.add_route("*", "/-/stats", self._stats_endpoint)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        logger.info("serve proxy listening on %s:%d", self.host, self.port)
        return True

    async def ready(self) -> bool:
        if not self._started:
            await self._start()
            self._started = True
        return True

    def _apply_route_table(self, table):
        """Normalize either route-table shape: legacy ``prefix -> name``
        strings or ``prefix -> {name, max_queued_requests}`` dicts."""
        routes: Dict[str, str] = {}
        cfg: Dict[str, dict] = {}
        for prefix, v in table.items():
            if isinstance(v, dict):
                routes[prefix] = v["name"]
                cfg[v["name"]] = v
            else:
                routes[prefix] = v
        self._routes = routes
        self._route_cfg = cfg

    def _on_routes_pushed(self, table):
        self._apply_route_table(table)

    async def _refresh_routes(self):
        import ray_tpu_torch

        deployments = await self._await_ref(self._controller.list_deployments.remote())
        self._apply_route_table(
            {
                (dep["config"].get("route_prefix") or f"/{name}"): {
                    "name": name,
                    "max_queued_requests": dep["config"].get(
                        "max_queued_requests", -1
                    ),
                    "tenant_quotas": dep["config"].get("tenant_quotas") or {},
                }
                for name, dep in deployments.items()
                if dep["config"].get("route_prefix") != ""  # "" = unrouted
            }
        )

    # -- load shedding ---------------------------------------------------
    def _try_admit(self, name: str, tenant: str = ""):
        """Admit one request against the deployment's in-flight bound;
        returns the 503 response when shed, else None (admitted — the
        caller MUST balance with _release)."""
        limit = int(self._route_cfg.get(name, {}).get("max_queued_requests", -1) or -1)
        cur = self._inflight.get(name, 0)
        if limit >= 0 and cur >= limit:
            self._shed[name] = self._shed.get(name, 0) + 1
            from ray_tpu_torch._private import telemetry

            telemetry.count_serve_shed(
                name, "proxy", tenant=self._tenant_label(name, tenant)
            )
            from aiohttp import web

            return web.Response(
                status=503,
                headers={"Retry-After": "1"},
                text=f"deployment {name} is at its queue bound ({limit}); retry",
            )
        self._inflight[name] = cur + 1
        return None

    def _release(self, name: str):
        self._inflight[name] = max(0, self._inflight.get(name, 1) - 1)

    # -- per-tenant token-rate quotas ------------------------------------
    def _buckets_for(self, name: str):
        """The deployment's TenantBuckets, rebuilt only when its quota
        table changed (bucket levels survive unrelated route pushes)."""
        from ray_tpu_torch.serve.llm.overload import TenantBuckets

        quotas = self._route_cfg.get(name, {}).get("tenant_quotas") or {}
        tb = self._tenant_buckets.get(name)
        if tb is None or tb.quotas != quotas:
            tb = self._tenant_buckets[name] = TenantBuckets(quotas)
        return tb

    def _tenant_label(self, name: str, tenant: str) -> str:
        from ray_tpu_torch._private.tenants import tenant_label

        quotas = self._route_cfg.get(name, {}).get("tenant_quotas") or {}
        return tenant_label(tenant, quotas.keys())

    @staticmethod
    def _identity(request, payload) -> tuple:
        """(tenant, slo) from headers / payload fields (payload wins)."""
        tenant = request.headers.get("x-serve-tenant", "")
        slo = request.headers.get("x-serve-slo", "")
        if isinstance(payload, dict):
            tenant = str(payload.get("tenant") or tenant)
            slo = str(payload.get("slo") or payload.get("slo_class") or slo)
        return tenant, slo

    @staticmethod
    def _estimate_tokens(payload) -> tuple:
        """(prompt_est, total_est): the worst-case token cost charged at
        admission — prompt length (byte-level tokenizer: bytes) plus the
        requested max_tokens.  Completion refunds the unused part."""
        prompt = payload.get("prompt", "") if isinstance(payload, dict) else payload
        if isinstance(prompt, (list, tuple)):
            prompt_est = len(prompt)
        elif isinstance(prompt, str):
            prompt_est = len(prompt.encode("utf-8"))
        else:
            prompt_est = 0
        mt = 32
        if isinstance(payload, dict):
            try:
                mt = max(1, int(payload.get("max_tokens") or 32))
            except (TypeError, ValueError):
                mt = 32
        return prompt_est, prompt_est + mt

    def _quota_admit(self, name: str, tenant: str, est: float):
        """Charge ``est`` tokens to the tenant's bucket; returns the 429
        response when over quota (shed lands on THIS tenant's counters),
        else None (charged — unused tokens must be refunded)."""
        tb = self._buckets_for(name)
        ok, retry_after = tb.charge(tenant or "default", est)
        if ok:
            return None
        label = self._tenant_label(name, tenant)
        per_dep = self._shed_tenant.setdefault(name, {})
        per_dep[label] = per_dep.get(label, 0) + 1
        from ray_tpu_torch._private import telemetry

        telemetry.count_serve_shed(name, "quota", tenant=label)
        from aiohttp import web

        return web.Response(
            status=429,
            headers={"Retry-After": str(max(1, int(retry_after)))},
            text=(f"tenant {label!r} is over its token-rate quota for "
                  f"deployment {name}; retry"),
        )

    @staticmethod
    def _shed_retry_after(e) -> str:
        """Retry-After for a RequestShedError that may have crossed the
        task boundary: the re-raised wrapper is a derived RayTaskError
        that carries only the original as ``.cause``."""
        v = getattr(e, "retry_after_s", None)
        if v is None:
            v = getattr(getattr(e, "cause", None), "retry_after_s", None)
        try:
            return str(max(1, int(v or 1)))
        except (TypeError, ValueError):
            return "1"

    async def _await_ref(self, ref):
        import ray_tpu_torch

        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(None, ray_tpu_torch.get, ref)

    async def _routes_endpoint(self, request):
        from aiohttp import web

        await self._refresh_routes()
        return web.json_response(self._routes)

    async def _healthz(self, request):
        from aiohttp import web

        return web.Response(text="ok")

    async def _stats_endpoint(self, request):
        """Per-deployment proxy counters: in-flight and shed totals."""
        from aiohttp import web

        return web.json_response(
            {
                "inflight": dict(self._inflight),
                "shed": dict(self._shed),
                "shed_tenant": {k: dict(v) for k, v in self._shed_tenant.items()},
            }
        )

    async def _handle_stream(self, request, handle, payload, name: str,
                             tenant: str = "", charged: int = 0,
                             prompt_est: int = 0, buckets=None):
        """Chunked response over a generator deployment: each yielded
        item becomes one chunk (json for dict/list, utf-8 text, raw
        bytes pass through); reference: http_util.py Response streaming.

        Disconnect-cancel contract (docs/serving.md): dict payloads get
        a ``__serve_stream_cancel__`` hint; a deployment that supports
        server-side cancellation answers with a FIRST stream item
        ``{"__serve_stream_meta__": {"request_id", "cancel_method"}}``
        (consumed here, never forwarded).  If the HTTP client goes away
        mid-stream, the proxy calls that method so the replica releases
        the request's resources (the LLM engine frees its KV blocks)."""
        import json as _json

        from aiohttp import web

        from ray_tpu_torch.serve.exceptions import RequestShedError

        # quota refund (satellite: disconnect/cancel must give back the
        # tenant's in-flight charge): before headers commit the whole
        # charge comes back; after, only the unstreamed share does
        streamed = 0
        committed = False

        def _refund_unused():
            if buckets is None or charged <= 0:
                return
            if not committed:
                buckets.refund(tenant or "default", charged)
            else:
                buckets.refund(
                    tenant or "default", max(0, charged - (prompt_est + streamed))
                )

        loop = asyncio.get_event_loop()
        if isinstance(payload, dict):
            payload = dict(payload)
            payload["__serve_stream_cancel__"] = True
        stream_handle = handle.options(stream=True)
        try:
            gen = await loop.run_in_executor(
                self._route_pool, stream_handle.remote, payload
            )
        except Exception as e:  # noqa: BLE001
            logger.exception("proxy stream routing failed")
            _refund_unused()
            return web.Response(status=500, text=str(e))
        it = iter(gen)

        def next_item():
            try:
                return True, next(it)
            except StopIteration:
                return False, None

        # fetch the FIRST item before committing headers: an error
        # before any yield still gets a clean 500/503
        cancel_meta = None
        try:
            more, item = await loop.run_in_executor(None, next_item)
            if more and isinstance(item, dict) and "__serve_stream_meta__" in item:
                cancel_meta = item["__serve_stream_meta__"]
                more, item = await loop.run_in_executor(None, next_item)
        except RequestShedError as e:
            _refund_unused()
            return web.Response(
                status=503,
                headers={"Retry-After": self._shed_retry_after(e)},
                text=str(e),
            )
        except Exception as e:  # noqa: BLE001
            logger.exception("stream failed before first item")
            _refund_unused()
            return web.Response(status=500, text=str(e))
        resp = web.StreamResponse()
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        committed = True
        disconnected = False
        try:
            while more:
                if isinstance(item, dict) and "token" in item:
                    streamed += 1
                if isinstance(item, (bytes, bytearray)):
                    chunk = bytes(item)
                elif isinstance(item, (dict, list)):
                    chunk = (_json.dumps(item) + "\n").encode()
                else:
                    chunk = str(item).encode()
                await resp.write(chunk)
                more, item = await loop.run_in_executor(None, next_item)
        except (ConnectionResetError, ConnectionError):
            disconnected = True
        except Exception:  # noqa: BLE001 — mid-stream replica error:
            # headers are committed; terminate the chunked body cleanly
            # rather than tearing the connection down
            logger.exception("stream failed mid-body")
        finally:
            if disconnected and cancel_meta:
                try:
                    # the cancel must reach the SAME replica serving this
                    # stream — a load-balanced handle call would land on
                    # a peer whose engine has no such request id
                    gen.call_same_replica(
                        cancel_meta.get("cancel_method", "cancel"),
                        cancel_meta["request_id"],
                    )
                except Exception:  # noqa: BLE001
                    logger.exception("disconnect-cancel failed")
            try:
                gen.close()
            except Exception:  # noqa: BLE001
                pass
            _refund_unused()
            try:
                await resp.write_eof()
            except (ConnectionResetError, ConnectionError):
                pass
        return resp

    async def _handle(self, request):
        from aiohttp import web

        from ray_tpu_torch.serve.handle import DeploymentHandle

        path = "/" + request.match_info["tail"]
        name = None
        for prefix, dep_name in sorted(self._routes.items(), key=lambda kv: -len(kv[0])):
            if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                name = dep_name
                break
        if name is None:
            await self._refresh_routes()
            for prefix, dep_name in sorted(self._routes.items(), key=lambda kv: -len(kv[0])):
                if path == prefix or path.startswith(prefix.rstrip("/") + "/"):
                    name = dep_name
                    break
        if name is None:
            return web.Response(status=404, text=f"no deployment for path {path}")
        handle = self._handles.get(name)
        if handle is None:
            handle = DeploymentHandle(name, self._controller)
            self._handles[name] = handle
        # request body: JSON → kwargs-style single payload argument
        if request.can_read_body:
            try:
                payload = await request.json()
            except Exception:
                payload = (await request.read()).decode("utf-8", "replace")
        else:
            payload = dict(request.query)
            # transport-level control key, never user data
            payload.pop("serve_stream", None)
        from ray_tpu_torch.serve.exceptions import RequestShedError

        loop = asyncio.get_event_loop()
        # request identity (tenant + SLO class) from headers / payload;
        # it rides the handle's request_meta all the way to the engine
        tenant, slo = self._identity(request, payload)
        shed = self._try_admit(name, tenant)
        if shed is not None:
            return shed
        prompt_est, est = self._estimate_tokens(payload)
        buckets = self._buckets_for(name)
        charged = 0
        used = None
        try:
            over = self._quota_admit(name, tenant, est)
            if over is not None:
                return over
            charged = est
            if tenant or slo:
                # derive per request, never cache: meta is per-call state
                handle = handle.options(
                    tenant=tenant or None, slo_class=slo or None
                )
            # streaming opt-in (reference: StreamingResponse deployments):
            # chunked transfer, one chunk per yielded item
            if request.headers.get("x-serve-stream") == "1" or request.query.get(
                "serve_stream"
            ) == "1":
                stream_charge, charged = charged, 0
                return await self._handle_stream(
                    request, handle, payload, name,
                    tenant=tenant, charged=stream_charge,
                    prompt_est=prompt_est, buckets=buckets,
                )
            try:
                # Routing may block (cold start waits for a replica,
                # refresh does a blocking get) — keep it off the proxy
                # event loop so /-/healthz and other deployments stay
                # responsive.
                response = await loop.run_in_executor(
                    self._route_pool, handle.remote, payload
                )
            except Exception as e:  # noqa: BLE001
                logger.exception("proxy routing failed")
                return web.Response(status=500, text=str(e))
            try:
                result = await self._await_ref(response.object_ref)
            except RequestShedError as e:
                # the engine shed it (typed, retryable): surface as 503,
                # same contract as the proxy's own bound
                return web.Response(
                    status=503,
                    headers={"Retry-After": self._shed_retry_after(e)},
                    text=str(e),
                )
            except Exception as e:  # noqa: BLE001
                logger.exception("proxy request failed")
                return web.Response(status=500, text=str(e))
            finally:
                # Always decrement the in-flight estimate — a failed
                # request must not permanently bias pow-2 routing and
                # autoscaling.
                response._router.done(response._replica_id)
            if isinstance(result, dict):
                try:
                    used = prompt_est + int(result.get("num_tokens") or 0)
                except (TypeError, ValueError):
                    used = None
            if isinstance(result, (dict, list)):
                return web.json_response(result)
            if isinstance(result, bytes):
                return web.Response(body=result)
            return web.Response(text=str(result))
        finally:
            if charged > 0:
                # give back the unused share of the worst-case charge
                # (the whole thing when the request failed or shed)
                buckets.refund(
                    tenant or "default",
                    charged if used is None else max(0, charged - used),
                )
            self._release(name)
