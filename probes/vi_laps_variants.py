"""MonoViSlam on the 300-frame laps with the IMU past VI init's refinement
window, on the card: where the async tracker that runs beside its worker
loses the map, and what changes it.

    python3 probes/vi_laps_variants.py variants
    python3 probes/vi_laps_variants.py seeds

chip_smoke.py's `_vi_laps_run` (test_async_vi's configuration, the port's
own two-view draw, frames at the camera's 10 fps unless said), after one
async frame that captures the graphs. `variants` (seed 0): lock-step;
async as committed; async with MonoSlam's keyframe gate on a saturated
queue taken out; async that holds a frame past the window while two jobs
are unfinished; async in step with the worker for the whole run; async
that holds a frame past the window until the running job has reached its
BA (its new points merged), at 10 fps and un-paced. `seeds`: lock-step
with own-draw seeds 1-3, async with seeds 1-2. Per run: the outcome and
the concurrent regime (chip_smoke's numbers); with `variants`, also each
frame's tracked features for frames 140-229 ("K" a keyframe, "I"
IMU-only). The variants are patched onto the instance here; nothing of
the port changes."""
import sys
import time

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from viorb_tpu_torch import default_device  # noqa: E402
from viorb_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from viorb_tpu_torch.slam import mono as mono_module  # noqa: E402
from viorb_tpu_torch.slam.mono_vi import MonoViSlam  # noqa: E402

tag = cs._card()
dev = default_device()
cam = PinholeCamera(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
laps, imu = cs._vi_laps(cam, dev)
warm = MonoViSlam(cam, device=dev, async_mapping=True, **cs.VI_CONFIG)
try:
    warm.process_frame_vi(laps.images[0], float(laps.timestamps[0]), [])
finally:
    warm.shutdown()
launches = {}
orig_init, orig_need = MonoViSlam.__init__, mono_module.MonoSlam._need_new_keyframe


def past_window(slam):
    last = slam.last_frame
    return slam.vi_ready and last is not None and last.timestamp - slam.init_time >= slam.init_refine_window


def no_saturation_gate(self, ts):
    """MonoSlam's keyframe rules without the saturated-queue gate."""
    if self.suppress_keyframes or self.localization_only or self.n_tracked <= 15:
        return False
    with self.map_lock:
        ref_tracked = int((self.map.keyframes[self.last_kf_id].point_idx >= 0).sum())
    return (self.frames_since_kf >= self.kf_max_interval
            or (self.frames_since_kf >= self.kf_min_interval and self.n_tracked < 0.6 * max(ref_tracked, 1)))


def with_wait(hold):
    """An __init__ whose frames wait, past the window, while hold(slam)."""
    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        wait0 = self._wait_for_worker

        def wait():
            if not past_window(self):
                return wait0()
            while hold(self):
                time.sleep(0.001)
        self._wait_for_worker = wait
    return init


def points_init(self, *a, **kw):
    """Frames past the window wait until no job is queued and the running
    one has reached its BA."""
    with_wait(lambda s: s._mapping_queue.qsize() or s._pre_ba)(self, *a, **kw)
    self._pre_ba = False
    job0, ba0 = self._mapping_job, self._mapping_ba

    def job(kf_id):
        self._pre_ba = True
        try:
            return job0(kf_id)
        finally:
            self._pre_ba = False

    def ba(kf_id, window):
        self._pre_ba = False
        return ba0(kf_id, window)
    self._mapping_job, self._mapping_ba = job, ba


def show(name, out, frames=True):
    rows = out.pop("rows")
    print(f"== {name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in out.items()))
    if frames:
        print("   n_tracked 140-229: " + " ".join(f"{r[4]}{'K' if r[5] else ''}{r[0][0] if r[0] != 'OK' else ''}"
                                               for r in rows[140:230]), flush=True)


def variant(name, init=orig_init, need=orig_need, **kw):
    MonoViSlam.__init__, mono_module.MonoSlam._need_new_keyframe = init, need
    try:
        show(name, cs._vi_laps_run(cam, laps, imu, tag, launches, **kw))
    finally:
        MonoViSlam.__init__, mono_module.MonoSlam._need_new_keyframe = orig_init, orig_need


if sys.argv[1:] == ["seeds"]:
    for async_mapping, seeds in ((False, (1, 2, 3)), (True, (1, 2))):
        for seed in seeds:
            show(f"{'async' if async_mapping else 'lock-step'} seed {seed}",
                 cs._vi_laps_run(cam, laps, imu, tag, launches, async_mapping=async_mapping, seed=seed), frames=False)
else:
    variant("lock-step", async_mapping=False)
    variant("async paced")
    variant("async paced, no vision saturation gate", need=no_saturation_gate)
    variant("async paced, backlog <= 1 after the window",
            init=with_wait(lambda s: s._mapping_queue.unfinished_tasks >= 2))
    variant("async paced, in step all run", init=with_wait(lambda s: s._mapping_queue.unfinished_tasks))
    variant("async paced, frames wait for the job's points", init=points_init)
    variant("async un-paced, frames wait for the job's points", init=points_init, paced=False)
