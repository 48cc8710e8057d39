"""How the data rows of a mesh share one card: the port's `mesh.Rows` (one
worker thread a device, running that device's rows in turn) against one
worker thread a row (without and with a CUDA stream of its own a row) and
against the one-device form, for ShardedDetBatch (5 held-out pages on the
960² canvas), ShardedRecBatch (64 crops of 48 × 640) and
`sharded_batch_fn` (4 pages), on a 4 × 1 grid of cuda:0 repeated and on
`make_mesh()`. Items a second from `chip_smoke._rate` (one unmeasured call,
then 3 between synchronisations), every variant twice, in turns
(forward, then backward). TF32 off, the committed v5 checkpoints.

    python3 ab_mesh.py [--out FILE.json]

Needs CUDA; prints the card's name and power limit and one JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np


def _row_threads(stream):
    """A mesh.Rows with one worker thread a row (optionally running each
    row on a CUDA stream of its own, synchronised before it returns)."""
    import torch
    from onnxocr_tpu_torch.parallel import mesh as mesh_lib

    class RowThreads(mesh_lib.Rows):
        def __init__(self, m):
            super().__init__(m)
            self._row_pools = [ThreadPoolExecutor(1, f"row-{i}")
                               for i in range(len(self.devices))]
            self._streams = [torch.cuda.Stream(d) if stream else None
                             for d in self.devices]

        def _one(self, i, fn, parts):
            s = self._streams[i]
            if s is None:
                return self._run([i], fn, parts)
            s.wait_stream(torch.cuda.current_stream(self.devices[i]))
            with torch.cuda.stream(s):
                out = self._run([i], fn, parts)
            s.synchronize()
            return out

        def map(self, fn, parts):
            futures = [pool.submit(self._one, i, fn, parts)
                       for i, pool in enumerate(self._row_pools)]
            wait(futures)
            done = [f.result()[0] for f in futures]
            for _, _, error in done:
                if error is not None:
                    raise error
            return [result for _, result, _ in done]

        def close(self):
            super().close()
            for pool in self._row_pools:
                pool.shutdown(wait=True)

    return RowThreads


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_mesh: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from onnxocr_tpu_torch import ONNXPaddleOcr, config
    from onnxocr_tpu_torch.ops import ctc, det_pre, resize_dev
    from onnxocr_tpu_torch.parallel import mesh as mesh_lib, serving
    from onnxocr_tpu_torch.utils.image import get_rotate_crop_image
    from onnxocr_tpu_torch.utils.png import read_bgr

    heldout = config.ASSETS.parent / "test_images_heldout"
    pages = {p: read_bgr(str(heldout / f"{p}.png")) for p in cs.PAGES}
    tmp = tempfile.mkdtemp()
    dict_path = os.path.join(tmp, "ppocrv5_dict.txt")
    with open(dict_path, "w") as f:
        f.write("".join(f"<{i}>\n" for i in range(18383)))
    ocr = ONNXPaddleOcr(device="cuda", rec_char_dict_path=dict_path,
                        tpu_pipeline="onecall", use_angle_cls=False)
    det_model = ocr.text_detector.model
    rec = ocr.text_recognizer
    rec_model = rec.forward.model
    canv = [det_pre.prepare_det_input(pages[n], 960, "max", bucket=320,
                                      canvas=(960, 960))
            for n in cs.M_DET_PAGES]
    pages_u8 = np.stack([c[0] for c in canv])
    rhw = np.array([c[2] for c in canv], np.int32)
    crops = []
    for n in cs.PAGES:
        for box in ocr.text_detector(pages[n]):
            crops.append(rec.resize_norm_img(get_rotate_crop_image(
                pages[n], np.asarray(box, np.float32)), 640)[0])
    crops = np.stack(crops[:64])
    oc = ocr._onecall
    ups = [resize_dev.put_src_bucket(pages[n], "cuda")
           for n in cs.M_ONECALL_PAGES]
    images = torch.stack([u[0] for u in ups])
    sh, sw = [u[1] for u in ups], [u[2] for u in ups]
    cv = [oc.canvas(h, w) for h, w in zip(sh, sw)]
    rh, rw = [c[0][0] for c in cv], [c[0][1] for c in cv]
    (hb, wb), _ = cv[0][1:]

    variants = {"device_threads": mesh_lib.Rows,
                "row_threads": _row_threads(False),
                "row_threads_streams": _row_threads(True)}
    meshes = {"4x1 cuda:0": lambda: mesh_lib.make_mesh(
        4, devices=["cuda:0"] * 4), "make_mesh()": mesh_lib.make_mesh}

    def one_det():
        x = det_pre.normalize_det(torch.from_numpy(pages_u8).cuda())
        ext = torch.from_numpy(rhw).cuda()
        return det_model(x.permute(0, 3, 1, 2),
                         valid_hw=(ext[:, 0], ext[:, 1]))

    # the one-device forms take the same host inputs as the sharded ones
    one_device = {
        "det": one_det,
        "rec": lambda: ctc.ctc_reduce_logits(rec_model(torch.from_numpy(
            crops).cuda().permute(0, 3, 1, 2)).float()),
        "onecall": lambda: oc.step_wave(images, sh, sw, rh, rw, hb, wb, 0,
                                        0, False).cpu()}
    counts = {"det": len(pages_u8), "rec": len(crops),
              "onecall": len(images)}
    results = {}
    real_rows = mesh_lib.Rows
    with torch.inference_mode():
        for mname, make in meshes.items():
            forms = {}
            for vname, cls in variants.items():
                mesh_lib.Rows = cls
                try:
                    m = make()
                    det = serving.ShardedDetBatch(det_model, m)
                    srec = serving.ShardedRecBatch(rec_model, m)
                    fn = oc.sharded_batch_fn(True, m)
                finally:
                    mesh_lib.Rows = real_rows
                forms[vname] = {
                    "det": lambda d=det: d(pages_u8, rhw),
                    "rec": lambda r=srec: r(crops),
                    "onecall": lambda f=fn: f(images, sh, sw, rh, rw).cpu()}
            forms["one_device"] = one_device
            order = list(forms)
            rates = {v: {k: [] for k in counts} for v in order}
            for turn in order + order[::-1]:
                for k in counts:
                    rates[turn][k].append(cs._rate(forms[turn][k],
                                                   counts[k]))
            results[mname] = rates
            for v in order:
                print(f"{mname} {v}: " + ", ".join(
                    f"{k} {rates[v][k][0]:.1f} / {rates[v][k][1]:.1f} "
                    f"items/s" for k in counts))
    line = {"ab_mesh": results, "card": smi,
            "device_count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f)
    print(json.dumps(line))
    ocr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
