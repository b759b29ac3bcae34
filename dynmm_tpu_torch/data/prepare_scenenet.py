#!/usr/bin/env python
"""Offline SceneNetRGBD conversion → the prepared png layout of
``SceneNetRGBDDataset`` (port of ``dynmm_tpu/data/prepare_scenenet.py``:
photos decoded by ``data/jpeg.py`` and PNGs read and written by
``data/png.py``, as the port imports no OpenCV; the written files hold
the same arrays).

Mirrors the semantics of the reference converter
(``FusionDynMM/src/datasets/scenenetrgbd/prepare_dataset.py``): parse the
protobuf trajectory files (``scenenet_rgbd_train_{0..16}.pb`` /
``scenenet_rgbd_val.pb``), build each trajectory's instance-id → NYU-13 class
mapping from the WordNet-id table (background → void 0; a view whose instance
png indexes past the trajectory's instance list invalidates the whole
trajectory, :253-268), randomly subsample ``n_views`` of the 300 views per
trajectory (seed 42; shortfalls are made up from subsequent trajectories,
:241/:377), optionally require ≥N distinct classes per view (:276-284), and
emit rgb / depth / labels_13 plus meta files.

Where the reference emits per-trajectory subdirectories + file-list txts,
this emits the SAME normalized layout every dataset here uses
(``{split}/{rgb,depth,labels_13}/{id}.png`` + ``{split}.txt``) with
``id = render-path with '/'→'_' + frame number``, so one reader serves all
datasets. The reference's protobuf schema (``scenenet.proto``) is decoded by
a ~50-line proto2 wire-format reader below — only the four fields the
converter needs — instead of requiring generated ``scenenet_pb2`` bindings.

Downloads are NOT attempted; point ``--scenenet-dir`` at the extracted
SceneNetRGBD tree (train/ val/ + .pb files).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field

import numpy as np

from dynmm_tpu_torch.data import jpeg, png

# WordNet id → NYU-13 class (void=0). Parity constant reproduced from the
# reference (prepare_dataset.py:32-96, itself from pySceneNetRGBD's
# convert_instance2class.py) — the label semantics depend on these numbers.
WNID_TO_NYU13 = {
    "04593077": 4, "03262932": 4, "02933112": 6, "03207941": 7,
    "03063968": 10, "04398044": 7, "04515003": 7, "00017222": 7,
    "02964075": 10, "03246933": 10, "03904060": 10, "03018349": 6,
    "03786621": 4, "04225987": 7, "04284002": 7, "03211117": 11,
    "02920259": 1, "03782190": 11, "03761084": 7, "03710193": 7,
    "03367059": 7, "02747177": 7, "03063599": 7, "04599124": 7,
    "20000036": 10, "03085219": 7, "04255586": 7, "03165096": 1,
    "03938244": 1, "14845743": 7, "03609235": 7, "03238586": 10,
    "03797390": 7, "04152829": 11, "04553920": 7, "04608329": 10,
    "20000016": 4, "02883344": 7, "04590933": 4, "04466871": 7,
    "03168217": 4, "03490884": 7, "04569063": 7, "03071021": 7,
    "03221720": 12, "03309808": 7, "04380533": 7, "02839910": 7,
    "03179701": 10, "02823510": 7, "03376595": 4, "03891251": 4,
    "03438257": 7, "02686379": 7, "03488438": 7, "04118021": 5,
    "03513137": 7, "04315948": 7, "03092883": 10, "15101854": 6,
    "03982430": 10, "02920083": 1, "02990373": 3, "03346455": 12,
    "03452594": 7, "03612814": 7, "06415419": 7, "03025755": 7,
    "02777927": 12, "04546855": 12, "20000040": 10, "20000041": 10,
    "04533802": 7, "04459362": 7, "04177755": 9, "03206908": 7,
    "20000021": 4, "03624134": 7, "04186051": 7, "04152593": 11,
    "03643737": 7, "02676566": 7, "02789487": 6, "03237340": 6,
    "04502670": 7, "04208936": 7, "20000024": 4, "04401088": 7,
    "04372370": 12, "20000025": 4, "03956922": 7, "04379243": 10,
    "04447028": 7, "03147509": 7, "03640988": 7, "03916031": 7,
    "03906997": 7, "04190052": 6, "02828884": 4, "03962852": 1,
    "03665366": 7, "02881193": 7, "03920867": 4, "03773035": 12,
    "03046257": 12, "04516116": 7, "00266645": 7, "03665924": 7,
    "03261776": 7, "03991062": 7, "03908831": 7, "03759954": 7,
    "04164868": 7, "04004475": 7, "03642806": 7, "04589593": 13,
    "04522168": 7, "04446276": 7, "08647616": 4, "02808440": 7,
    "08266235": 10, "03467517": 7, "04256520": 9, "04337974": 7,
    "03990474": 7, "03116530": 6, "03649674": 4, "04349401": 7,
    "01091234": 7, "15075141": 7, "20000028": 9, "02960903": 7,
    "04254009": 7, "20000018": 4, "20000020": 4, "03676759": 11,
    "20000022": 4, "20000023": 4, "02946921": 7, "03957315": 7,
    "20000026": 4, "20000027": 4, "04381587": 10, "04101232": 7,
    "03691459": 7, "03273913": 7, "02843684": 7, "04183516": 7,
    "04587648": 13, "02815950": 3, "03653583": 6, "03525454": 7,
    "03405725": 6, "03636248": 7, "03211616": 11, "04177820": 4,
    "04099969": 4, "03928116": 7, "04586225": 7, "02738535": 4,
    "20000039": 10, "20000038": 10, "04476259": 7, "04009801": 11,
    "03909406": 12, "03002711": 7, "03085602": 11, "03233905": 6,
    "20000037": 10, "02801938": 7, "03899768": 7, "04343346": 7,
    "03603722": 7, "03593526": 7, "02954340": 7, "02694662": 7,
    "04209613": 7, "02951358": 7, "03115762": 9, "04038727": 6,
    "03005285": 7, "04559451": 7, "03775636": 7, "03620967": 10,
    "02773838": 7, "20000008": 6, "04526964": 7, "06508816": 7,
    "20000009": 6, "03379051": 7, "04062428": 7, "04074963": 7,
    "04047401": 7, "03881893": 13, "03959485": 7, "03391301": 7,
    "03151077": 12, "04590263": 13, "20000006": 1, "03148324": 6,
    "20000004": 1, "04453156": 7, "02840245": 2, "04591713": 7,
    "03050864": 7, "03727837": 5, "06277280": 11, "03365592": 5,
    "03876519": 8, "03179910": 7, "06709442": 7, "03482252": 7,
    "04223580": 7, "02880940": 7, "04554684": 7, "20000030": 9,
    "03085013": 7, "03169390": 7, "04192858": 7, "20000029": 9,
    "04331277": 4, "03452741": 7, "03485997": 7, "20000007": 1,
    "02942699": 7, "03231368": 10, "03337140": 7, "03001627": 4,
    "20000011": 6, "20000010": 6, "20000013": 6, "04603729": 10,
    "20000015": 4, "04548280": 12, "06410904": 2, "04398951": 10,
    "03693474": 9, "04330267": 7, "03015149": 9, "04460038": 7,
    "03128519": 7, "04306847": 7, "03677231": 7, "02871439": 6,
    "04550184": 6, "14974264": 7, "04344873": 9, "03636649": 7,
    "20000012": 6, "02876657": 7, "03325088": 7, "04253437": 7,
    "02992529": 7, "03222722": 12, "04373704": 4, "02851099": 13,
    "04061681": 10, "04529681": 7,
}

CLASS_NAMES_13 = [
    "void", "bed", "books", "ceiling", "chair", "floor", "furniture",
    "objects", "picture", "sofa", "table", "tv", "wall", "window",
]

N_VIEWS_PER_TRAJECTORY = 300
BACKGROUND = 1  # Instance.InstanceType.BACKGROUND (scenenet.proto)

PB_FILENAMES = {
    "train": [f"scenenet_rgbd_train_{i}.pb" for i in range(17)],
    "test": ["scenenet_rgbd_val.pb"],
}
SPLIT_SUBDIR = {"train": "train", "test": "val"}


# ------------------------------------------------------------------ protobuf
# Minimal proto2 wire-format reader for scenenet.proto — just the fields the
# converter consumes: Trajectories.trajectories → Trajectory{instances=2,
# views=3, render_path=4}, Instance{instance_id=1, semantic_wordnet_id=2,
# instance_type=4}, View{frame_num=1}. Unknown fields are skipped by wire
# type, so richer .pb files (poses, lights, layouts) parse fine.

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        elif wtype == 1:  # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


@dataclass
class Instance:
    instance_id: int = 0
    semantic_wordnet_id: str = ""
    instance_type: int = 0


@dataclass
class View:
    frame_num: int = 0


@dataclass
class Trajectory:
    render_path: str = ""
    instances: list = field(default_factory=list)
    views: list = field(default_factory=list)


def parse_trajectories(data: bytes) -> list[Trajectory]:
    """Decode a ``Trajectories`` protobuf (scenenet.proto) payload."""
    out = []
    for fnum, _, val in _iter_fields(data):
        if fnum != 1:
            continue
        traj = Trajectory()
        for tf, _, tv in _iter_fields(val):
            if tf == 2:  # instances
                inst = Instance()
                for f2, _, v2 in _iter_fields(tv):
                    if f2 == 1:
                        inst.instance_id = v2
                    elif f2 == 2:
                        inst.semantic_wordnet_id = v2.decode()
                    elif f2 == 4:
                        inst.instance_type = v2
                traj.instances.append(inst)
            elif tf == 3:  # views
                view = View()
                for f2, _, v2 in _iter_fields(tv):
                    if f2 == 1:
                        view.frame_num = v2
                traj.views.append(view)
            elif tf == 4:  # render_path
                traj.render_path = tv.decode()
        out.append(traj)
    return out


# ----------------------------------------------------------------- convert
def _instance_mapping(traj: Trajectory) -> np.ndarray:
    """instance_id → class (uint8); background/void instances map to 0."""
    mapping = np.zeros(len(traj.instances), dtype=np.uint8)
    for inst in traj.instances:
        if inst.instance_type == BACKGROUND:
            continue
        mapping[inst.instance_id] = WNID_TO_NYU13[inst.semantic_wordnet_id]
    return mapping


def convert(
    output_dir: str,
    scenenet_dir: str,
    n_views_train: int = N_VIEWS_PER_TRAJECTORY,
    n_views_test: int = N_VIEWS_PER_TRAJECTORY,
    min_classes_in_view: int = -1,
    seed: int = 42,
) -> dict:
    """Returns {split: n_samples}. Layout: ``{split}/{rgb,depth,labels_13}/
    {id}.png`` + ``{split}.txt``; ids flatten the trajectory render path."""
    rng = np.random.RandomState(seed)
    counts = {}
    for split, n_views in (("train", n_views_train), ("test", n_views_test)):
        src_root = os.path.join(scenenet_dir, SPLIT_SUBDIR[split])
        out_root = os.path.join(output_dir, split)
        for d in ("rgb", "depth", "labels_13"):
            os.makedirs(os.path.join(out_root, d), exist_ok=True)

        ids: list[str] = []
        trajectories: list[Trajectory] = []
        for fn in PB_FILENAMES[split]:
            path = os.path.join(scenenet_dir, fn)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                trajectories.extend(parse_trajectories(f.read()))

        n_views_missing = 0
        for traj in trajectories:
            mapping = _instance_mapping(traj)
            picked: list[str] = []
            n_to_pick = n_views + n_views_missing
            n_avail = len(traj.views)
            for i in rng.permutation(max(n_avail, 1)):
                if i >= n_avail:
                    break
                view = traj.views[i]
                src = os.path.join(src_root, traj.render_path)
                inst_fp = os.path.join(src, "instance",
                                       f"{view.frame_num}.png")
                instance = (png.read(inst_fp) if os.path.exists(inst_fp)
                            else None)
                if instance is None or instance.max() >= len(mapping):
                    # reference: a bad view discards the whole trajectory
                    picked = []
                    break
                label = mapping[instance]
                if (
                    min_classes_in_view != -1
                    and len(np.unique(label)) < min_classes_in_view
                ):
                    continue
                sid = f"{traj.render_path.replace('/', '_')}_{view.frame_num}"
                rgb = jpeg.read(
                    os.path.join(src, "photo", f"{view.frame_num}.jpg"),
                    color=True,
                )
                depth = png.read(
                    os.path.join(src, "depth", f"{view.frame_num}.png"))
                png.write(os.path.join(out_root, "rgb", f"{sid}.png"), rgb)
                png.write(
                    os.path.join(out_root, "depth", f"{sid}.png"),
                    depth.astype(np.uint16),
                )
                png.write(
                    os.path.join(out_root, "labels_13", f"{sid}.png"), label
                )
                picked.append(sid)
                if len(picked) == n_to_pick:
                    break
            ids.extend(picked)
            n_views_missing = max(0, n_to_pick - len(picked))

        with open(os.path.join(output_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + ("\n" if ids else ""))
        counts[split] = len(ids)

    np.savetxt(
        os.path.join(output_dir, "class_names_1+13.txt"),
        CLASS_NAMES_13, delimiter=",", fmt="%s",
    )
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Prepare SceneNetRGBD for segmentation."
    )
    p.add_argument("output_path")
    p.add_argument("--scenenet-dir", required=True,
                   help="extracted SceneNetRGBD tree (train/ val/ + .pb)")
    p.add_argument("--n-random-views-to-include-train", type=int,
                   default=N_VIEWS_PER_TRAJECTORY)
    p.add_argument("--n-random-views-to-include-valid", type=int,
                   default=N_VIEWS_PER_TRAJECTORY)
    p.add_argument("--force-at-least-n-classes-in-view", type=int, default=-1)
    args = p.parse_args(argv)
    counts = convert(
        os.path.expanduser(args.output_path),
        os.path.expanduser(args.scenenet_dir),
        n_views_train=args.n_random_views_to_include_train,
        n_views_test=args.n_random_views_to_include_valid,
        min_classes_in_view=args.force_at_least_n_classes_in_view,
    )
    print(counts)


if __name__ == "__main__":
    main()
