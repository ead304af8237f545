"""Asynchronous mapper actor: the keyframe backend on its own host thread.

Counterpart of plvs_tpu/slam/async_runtime.py (``SystemConfig.
async_mapping``). One actor thread drains a keyframe queue and runs the
System's whole backend per keyframe (local mapping, dense integration, loop
closing) while the tracking thread goes on:

* map consistency comes from the coarse ``MapStore.lock``: the tracker's
  candidate gathers and keyframe creation and the actor's mutating stages
  hold it; device solves run outside it;
* both threads launch on the device's default stream, so their work
  serialises on the device and no tensor crosses streams; the actor thread
  enters its device first;
* a keyframe queued while the actor is inside a local BA sets the abort
  flag, and the BA stops after its current chunk (``LocalMapper.
  abort_check``, ``ba_chunk_iters``);
* a loop closure moves the keyframes under the tracker: the actor records
  the pose of the tracker's reference keyframe before the pass, and the
  tracker folds the reference's change into its pose at the next frame
  (:meth:`apply_pending_correction`);
* an exception in the actor is raised on the tracking thread at the next
  :meth:`insert_keyframe`.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch


class MapperActor:
    def __init__(self, system):
        self.system = system
        self.queue: queue.Queue = queue.Queue()
        self.abort_ba = threading.Event()
        self._busy = threading.Event()
        self._stop = False
        self._error = None
        self._correction_lock = threading.Lock()
        self._pending_correction = None  # (ref_kf, R_old, t_old)
        system.local_mapper.abort_check = self.abort_ba.is_set
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="plvs-mapper")
        self.thread.start()

    # -- tracking-thread API ------------------------------------------------
    def insert_keyframe(self, kf_id: int, dense_payload=None):
        """Queue a keyframe for the backend and interrupt a running local
        BA; raises the actor's last error, if any."""
        self.abort_ba.set()
        self.queue.put((kf_id, dense_payload))
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"mapper actor failed: {err}") from err

    def apply_pending_correction(self):
        """Fold a loop correction into the tracker's pose:
        T_frame' = T_frame * T_ref_old^-1 * T_ref_new."""
        with self._correction_lock:
            pend, self._pending_correction = self._pending_correction, None
        if pend is None:
            return
        ref_kf, R_old, t_old = pend
        st = self.system.store
        with st.lock:
            if not st.kf_mask[ref_kf]:
                return
            R_new, t_new = st.kf_R[ref_kf].copy(), st.kf_t[ref_kf].copy()
        tr = self.system.tracker
        dR = R_old.T @ R_new
        dt = R_old.T @ (t_new - t_old)
        R_f, t_f = tr.R, tr.t
        tr.R = (R_f @ dR).astype(np.float32)
        tr.t = (R_f @ dt + t_f).astype(np.float32)

    def idle(self) -> bool:
        return self.queue.empty() and not self._busy.is_set()

    def wait_idle(self, timeout: float = 60.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.idle():
                return True
            time.sleep(0.005)
        return False

    def shutdown(self, timeout: float = 120.0):
        self.wait_idle(timeout)
        self._stop = True
        self.queue.put(None)
        self.thread.join(timeout=10.0)

    # -- actor thread ---------------------------------------------------------
    def _run(self):
        dev = self.system.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            self._loop()

    def _loop(self):
        sys_ = self.system
        while True:
            item = self.queue.get()
            if item is None or self._stop:
                return
            kf_id, payload = item
            self._busy.set()
            self.abort_ba.clear()
            try:
                ref_before = sys_.tracker.ref_kf
                st = sys_.store
                with st.lock:
                    ok = 0 <= ref_before < st.max_kf and st.kf_mask[ref_before]
                    if ok:
                        R_old = st.kf_R[ref_before].copy()
                        t_old = st.kf_t[ref_before].copy()
                n_loops = len(sys_.loops_closed)
                sys_._backend_keyframe(kf_id, payload)
                if ok and len(sys_.loops_closed) > n_loops:
                    with self._correction_lock:
                        self._pending_correction = (ref_before, R_old, t_old)
            except Exception as e:  # raised at the next insert
                self._error = e
            finally:
                self._busy.clear()
