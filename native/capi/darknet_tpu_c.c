/* C ABI shim: embeds CPython and drives darknet_tpu.Network.
 * See darknet_tpu_c.h.  Reference surface: yolo_core.h:625-663. */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "darknet_tpu_c.h"

static int g_inited = 0;

static void ensure_python(void)
{
  if (g_inited) return;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  /* DTPU_PLATFORM selects JAX's platforms before the backend starts */
  const char* plat = getenv("DTPU_PLATFORM");
  if (plat && *plat) {
    char buf[256];
    snprintf(buf, sizeof buf,
             "import jax; jax.config.update('jax_platforms', '%s')", plat);
    PyRun_SimpleString(buf);
  }
  PyGILState_Release(gil);
  g_inited = 1;
}

dtpu_net dtpu_load2(const char* cfg_path, const char* weights_path,
                    int train, int clear)
{
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  dtpu_net handle = NULL;
  PyObject* mod = PyImport_ImportModule("darknet_tpu.nn.network");
  if (!mod) { PyErr_Print(); goto done; }
  PyObject* cls = PyObject_GetAttrString(mod, "Network");
  Py_DECREF(mod);
  if (!cls) { PyErr_Print(); goto done; }
  PyObject* from_cfg = PyObject_GetAttrString(cls, "from_cfg");
  Py_DECREF(cls);
  if (!from_cfg) { PyErr_Print(); goto done; }
  PyObject* args = Py_BuildValue("(s)", cfg_path);
  PyObject* kw = PyDict_New();
  if (weights_path && *weights_path) {
    PyObject* w = PyUnicode_FromString(weights_path);
    PyDict_SetItemString(kw, "weights", w);
    Py_DECREF(w);
  }
  if (train) {
    PyDict_SetItemString(kw, "train", Py_True);
    PyDict_SetItemString(kw, "fuse", Py_False);
  }
  if (clear) PyDict_SetItemString(kw, "clear", Py_True);
  PyObject* net = PyObject_Call(from_cfg, args, kw);
  Py_DECREF(from_cfg);
  Py_DECREF(args);
  Py_DECREF(kw);
  if (!net) { PyErr_Print(); goto done; }
  handle = (dtpu_net)net;  /* owned reference held by the C caller */
done:
  PyGILState_Release(gil);
  return handle;
}

dtpu_net dtpu_load(const char* cfg_path, const char* weights_path)
{
  return dtpu_load2(cfg_path, weights_path, 0, 0);
}

static long net_attr_int(dtpu_net net, const char* attr)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  long v = -1;
  PyObject* cfg = PyObject_GetAttrString((PyObject*)net, "net");
  if (cfg) {
    PyObject* a = PyObject_GetAttrString(cfg, attr);
    Py_DECREF(cfg);
    if (a) { v = PyLong_AsLong(a); Py_DECREF(a); }
  }
  if (PyErr_Occurred()) { PyErr_Print(); v = -1; }
  PyGILState_Release(gil);
  return v;
}

int dtpu_input_w(dtpu_net net) { return (int)net_attr_int(net, "w"); }
int dtpu_input_h(dtpu_net net) { return (int)net_attr_int(net, "h"); }
int dtpu_input_c(dtpu_net net) { return (int)net_attr_int(net, "c"); }

int dtpu_classes(dtpu_net net)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  long v = -1;
  PyObject* r = PyObject_CallMethod((PyObject*)net, "classes", NULL);
  if (!r) {
    PyErr_Clear();
    /* fall back: last head's classes */
    PyObject* g = PyObject_GetAttrString((PyObject*)net, "graph");
    if (g) {
      PyObject* heads = PyObject_CallMethod(g, "heads", NULL);
      Py_DECREF(g);
      if (heads && PyList_Size(heads) > 0) {
        PyObject* h = PyList_GetItem(heads, PyList_Size(heads) - 1);
        PyObject* c = PyObject_GetAttrString(h, "classes");
        if (c) { v = PyLong_AsLong(c); Py_DECREF(c); }
      }
      Py_XDECREF(heads);
    }
  } else {
    v = PyLong_AsLong(r);
    Py_DECREF(r);
  }
  if (PyErr_Occurred()) { PyErr_Print(); v = -1; }
  PyGILState_Release(gil);
  return (int)v;
}

int dtpu_detect(dtpu_net net, const float* rgb, float thresh, float nms,
                dtpu_detection* out, int max_out)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  int n = -1;
  int h = 0, w = 0, c = 0;
  {
    PyObject* cfg = PyObject_GetAttrString((PyObject*)net, "net");
    if (!cfg) goto done;
    PyObject *pw = PyObject_GetAttrString(cfg, "w"),
             *ph = PyObject_GetAttrString(cfg, "h"),
             *pc = PyObject_GetAttrString(cfg, "c");
    Py_DECREF(cfg);
    if (!pw || !ph || !pc) { Py_XDECREF(pw); Py_XDECREF(ph); Py_XDECREF(pc); goto done; }
    w = (int)PyLong_AsLong(pw); h = (int)PyLong_AsLong(ph);
    c = (int)PyLong_AsLong(pc);
    Py_DECREF(pw); Py_DECREF(ph); Py_DECREF(pc);
  }
  {
    /* numpy array wrapping the caller's buffer (copied by bytes to keep
       lifetime simple) */
    PyObject* np = PyImport_ImportModule("numpy");
    if (!np) { PyErr_Print(); goto done; }
    Py_ssize_t nbytes = (Py_ssize_t)h * w * c * (Py_ssize_t)sizeof(float);
    PyObject* bytes = PyBytes_FromStringAndSize((const char*)rgb, nbytes);
    PyObject* frombuffer = PyObject_GetAttrString(np, "frombuffer");
    PyObject* arr1d = PyObject_CallFunction(frombuffer, "Os", bytes,
                                            "float32");
    Py_DECREF(frombuffer);
    Py_DECREF(bytes);
    Py_DECREF(np);
    if (!arr1d) { PyErr_Print(); goto done; }
    PyObject* arr = PyObject_CallMethod(arr1d, "reshape", "(iii)", h, w, c);
    Py_DECREF(arr1d);
    if (!arr) { PyErr_Print(); goto done; }

    PyObject* dets = PyObject_CallMethod(
        (PyObject*)net, "detect", "Off", arr, (double)thresh, (double)nms);
    Py_DECREF(arr);
    if (!dets) { PyErr_Print(); goto done; }

    Py_ssize_t nd = PyList_Size(dets);
    if (nd > max_out) nd = max_out;
    for (Py_ssize_t i = 0; i < nd; i++) {
      PyObject* d = PyList_GetItem(dets, i);
      PyObject* bbox = PyObject_GetAttrString(d, "bbox");
      PyObject* obj = PyObject_GetAttrString(d, "objectness");
      PyObject* bc = PyObject_GetAttrString(d, "best_class");
      PyObject* bp = PyObject_GetAttrString(d, "best_prob");
      if (!bbox || !obj || !bc || !bp) {
        Py_XDECREF(bbox); Py_XDECREF(obj); Py_XDECREF(bc); Py_XDECREF(bp);
        Py_DECREF(dets);
        goto done;
      }
      out[i].x = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 0));
      out[i].y = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 1));
      out[i].w = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 2));
      out[i].h = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 3));
      out[i].objectness = (float)PyFloat_AsDouble(obj);
      out[i].best_class = (int)PyLong_AsLong(bc);
      out[i].best_prob = (float)PyFloat_AsDouble(bp);
      Py_DECREF(bbox); Py_DECREF(obj); Py_DECREF(bc); Py_DECREF(bp);
    }
    Py_DECREF(dets);
    n = (int)nd;
  }
done:
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(gil);
  return n;
}

int dtpu_save_weights(dtpu_net net, const char* path)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  PyObject* r = PyObject_CallMethod((PyObject*)net, "save_weights", "s",
                                    path);
  if (r) { rc = 0; Py_DECREF(r); } else { PyErr_Print(); }
  PyGILState_Release(gil);
  return rc;
}

/* build an HWC float32 numpy array from the caller's buffer using the
   net's input dims (shared by dtpu_detect and dtpu_detect_json) */
static PyObject* wrap_input(dtpu_net net, const float* rgb)
{
  PyObject* cfg = PyObject_GetAttrString((PyObject*)net, "net");
  if (!cfg) return NULL;
  PyObject *pw = PyObject_GetAttrString(cfg, "w"),
           *ph = PyObject_GetAttrString(cfg, "h"),
           *pc = PyObject_GetAttrString(cfg, "c");
  Py_DECREF(cfg);
  if (!pw || !ph || !pc) {
    Py_XDECREF(pw); Py_XDECREF(ph); Py_XDECREF(pc);
    return NULL;
  }
  int w = (int)PyLong_AsLong(pw), h = (int)PyLong_AsLong(ph),
      c = (int)PyLong_AsLong(pc);
  Py_DECREF(pw); Py_DECREF(ph); Py_DECREF(pc);
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) return NULL;
  Py_ssize_t nbytes = (Py_ssize_t)h * w * c * (Py_ssize_t)sizeof(float);
  PyObject* bytes = PyBytes_FromStringAndSize((const char*)rgb, nbytes);
  PyObject* frombuffer = PyObject_GetAttrString(np, "frombuffer");
  PyObject* arr1d = PyObject_CallFunction(frombuffer, "Os", bytes,
                                          "float32");
  Py_DECREF(frombuffer);
  Py_DECREF(bytes);
  Py_DECREF(np);
  if (!arr1d) return NULL;
  PyObject* arr = PyObject_CallMethod(arr1d, "reshape", "(iii)", h, w, c);
  Py_DECREF(arr1d);
  return arr;
}

char* dtpu_detect_json(dtpu_net net, const float* rgb, float thresh,
                       float nms, long long frame_id, const char* filename)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  char* out = NULL;
  PyObject *arr = NULL, *dets = NULL, *mod = NULL, *fn = NULL, *js = NULL;
  arr = wrap_input(net, rgb);
  if (!arr) goto done;
  dets = PyObject_CallMethod((PyObject*)net, "detect", "Off", arr,
                             (double)thresh, (double)nms);
  if (!dets) goto done;
  mod = PyImport_ImportModule("darknet_tpu.nn.network");
  if (!mod) goto done;
  fn = PyObject_GetAttrString(mod, "detections_to_json");
  if (!fn) goto done;
  {
    PyObject* fargs = Py_BuildValue("(OL)", dets, frame_id);
    PyObject* fkw = PyDict_New();
    if (filename) {
      PyObject* f = PyUnicode_FromString(filename);
      PyDict_SetItemString(fkw, "filename", f);
      Py_DECREF(f);
    }
    js = PyObject_Call(fn, fargs, fkw);
    Py_DECREF(fargs);
    Py_DECREF(fkw);
  }
  if (!js) goto done;
  {
    const char* s = PyUnicode_AsUTF8(js);
    if (s) out = strdup(s);
  }
done:
  Py_XDECREF(js); Py_XDECREF(fn); Py_XDECREF(mod);
  Py_XDECREF(dets); Py_XDECREF(arr);
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(gil);
  return out;
}

void dtpu_free_str(char* s) { free(s); }

float dtpu_validate(dtpu_net net, const char* data_file, float iou_thresh)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  float v = -1.0f;
  PyObject *mdmod = NULL, *mdcls = NULL, *md = NULL, *paths = NULL,
           *evmod = NULL, *fn = NULL, *kw = NULL, *args = NULL, *res = NULL;
  mdmod = PyImport_ImportModule("darknet_tpu.config.metadata");
  if (!mdmod) goto done;
  mdcls = PyObject_GetAttrString(mdmod, "Metadata");
  if (!mdcls) goto done;
  md = PyObject_CallMethod(mdcls, "from_file", "s", data_file);
  if (!md) goto done;
  paths = PyObject_CallMethod(md, "load_paths", "s", "valid");
  if (!paths) goto done;
  evmod = PyImport_ImportModule("darknet_tpu.eval.map");
  if (!evmod) goto done;
  fn = PyObject_GetAttrString(evmod, "validate_detector");
  if (!fn) goto done;
  {
    PyObject* classes = PyObject_GetAttrString(md, "classes");
    if (!classes) goto done;
    args = Py_BuildValue("(OOO)", (PyObject*)net, paths, classes);
    Py_DECREF(classes);
  }
  kw = Py_BuildValue("{s:f,s:O}", "iou_thresh", (double)iou_thresh,
                     "progress", Py_False);
  res = PyObject_Call(fn, args, kw);
  if (!res) goto done;
  {
    PyObject* m = PyObject_GetAttrString(res, "map");
    if (m) { v = (float)PyFloat_AsDouble(m); Py_DECREF(m); }
  }
done:
  Py_XDECREF(res); Py_XDECREF(kw); Py_XDECREF(args); Py_XDECREF(fn);
  Py_XDECREF(evmod); Py_XDECREF(paths); Py_XDECREF(md); Py_XDECREF(mdcls);
  Py_XDECREF(mdmod);
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(gil);
  return v;
}

void dtpu_free(dtpu_net net)
{
  if (!net) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_DECREF((PyObject*)net);
  PyGILState_Release(gil);
}

float dtpu_train(const char* data_file, const char* cfg_path,
                 const char* weights_path, int clear, int max_iters)
{
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  float v = NAN; /* error sentinel: -1.0 is a LEGITIMATE return (the
                    EMA avg-loss init, when zero iterations ran) */
  PyObject *mod = NULL, *fn = NULL, *args = NULL, *kw = NULL, *res = NULL;
  mod = PyImport_ImportModule("darknet_tpu.train.trainer");
  if (!mod) goto done;
  fn = PyObject_GetAttrString(mod, "train_detector");
  if (!fn) goto done;
  args = Py_BuildValue("(ss)", data_file, cfg_path);
  kw = PyDict_New();
  if (weights_path && *weights_path) {
    PyObject* w = PyUnicode_FromString(weights_path);
    PyDict_SetItemString(kw, "weights_file", w);
    Py_DECREF(w);
  }
  if (clear) PyDict_SetItemString(kw, "clear", Py_True);
  if (max_iters > 0) {
    PyObject* m = PyLong_FromLong(max_iters);
    PyDict_SetItemString(kw, "max_iters", m);
    Py_DECREF(m);
  }
  res = PyObject_Call(fn, args, kw);
  if (res) v = (float)PyFloat_AsDouble(res);
done:
  Py_XDECREF(res); Py_XDECREF(kw); Py_XDECREF(args); Py_XDECREF(fn);
  Py_XDECREF(mod);
  if (PyErr_Occurred()) { PyErr_Print(); v = NAN; }
  PyGILState_Release(gil);
  return v;
}

/* ---- tracker ---- */

dtpu_tracker dtpu_tracker_new(float fps, float iou_thresh)
{
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  dtpu_tracker handle = NULL;
  PyObject *mod = NULL, *cp_cls = NULL, *cp = NULL, *tm_cls = NULL;
  mod = PyImport_ImportModule("darknet_tpu.apps.tracker");
  if (!mod) goto done;
  cp_cls = PyObject_GetAttrString(mod, "ConfParam");
  if (!cp_cls) goto done;
  cp = PyObject_CallMethod(cp_cls, "from_fps", "f", (double)fps);
  if (!cp) goto done;
  tm_cls = PyObject_GetAttrString(mod, "TrackManager");
  if (!tm_cls) goto done;
  handle = (dtpu_tracker)PyObject_CallFunction(
      tm_cls, "Off", cp, (double)fps, (double)iou_thresh);
done:
  Py_XDECREF(tm_cls); Py_XDECREF(cp); Py_XDECREF(cp_cls); Py_XDECREF(mod);
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(gil);
  return handle;
}

int dtpu_tracker_update(dtpu_tracker t, const dtpu_detection* dets, int n)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  PyObject *mod = NULL, *mpd_cls = NULL, *list = NULL, *res = NULL;
  mod = PyImport_ImportModule("darknet_tpu.apps.tracker");
  if (!mod) goto done;
  mpd_cls = PyObject_GetAttrString(mod, "MostProbDet");
  if (!mpd_cls) goto done;
  list = PyList_New(0);
  for (int i = 0; i < n; i++) {
    PyObject* d = PyObject_CallFunction(
        mpd_cls, "(ffff)if", (double)dets[i].x, (double)dets[i].y,
        (double)dets[i].w, (double)dets[i].h, dets[i].best_class,
        (double)dets[i].best_prob);
    if (!d) goto done;
    PyList_Append(list, d);
    Py_DECREF(d);
  }
  res = PyObject_CallMethod((PyObject*)t, "track", "O", list);
  if (res) rc = 0;
done:
  Py_XDECREF(res); Py_XDECREF(list); Py_XDECREF(mpd_cls); Py_XDECREF(mod);
  if (PyErr_Occurred()) { PyErr_Print(); rc = -1; }
  PyGILState_Release(gil);
  return rc;
}

int dtpu_tracker_tracks(dtpu_tracker t, dtpu_track_info* out, int max_out)
{
  PyGILState_STATE gil = PyGILState_Ensure();
  int n = -1;
  PyObject *mod = NULL, *stat = NULL, *tracks = NULL;
  mod = PyImport_ImportModule("darknet_tpu.apps.tracker");
  if (!mod) goto done;
  stat = PyObject_GetAttrString(mod, "STATIONARY");
  if (!stat) goto done;
  tracks = PyObject_CallMethod((PyObject*)t, "get_tracks", NULL);
  if (!tracks) goto done;
  {
    Py_ssize_t nt = PyList_Size(tracks);
    if (nt > max_out) nt = max_out;
    for (Py_ssize_t i = 0; i < nt; i++) {
      PyObject* tr = PyList_GetItem(tracks, i);
      PyObject* det = PyObject_GetAttrString(tr, "det");
      PyObject* label = PyObject_GetAttrString(tr, "label");
      PyObject* status = PyObject_GetAttrString(tr, "status");
      if (!det || !label || !status) {
        Py_XDECREF(det); Py_XDECREF(label); Py_XDECREF(status);
        goto done;
      }
      PyObject* bbox = PyObject_GetAttrString(det, "bbox");
      PyObject* cid = PyObject_GetAttrString(det, "cid");
      PyObject* prob = PyObject_GetAttrString(det, "prob");
      if (!bbox || !cid || !prob) {
        Py_XDECREF(bbox); Py_XDECREF(cid); Py_XDECREF(prob);
        Py_DECREF(det); Py_DECREF(label); Py_DECREF(status);
        goto done;
      }
      out[i].x = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 0));
      out[i].y = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 1));
      out[i].w = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 2));
      out[i].h = (float)PyFloat_AsDouble(PyTuple_GetItem(bbox, 3));
      out[i].cid = (int)PyLong_AsLong(cid);
      out[i].prob = (float)PyFloat_AsDouble(prob);
      out[i].label = (int)PyLong_AsLong(label);
      out[i].stationary =
          PyObject_RichCompareBool(status, stat, Py_EQ) == 1 ? 1 : 0;
      Py_DECREF(bbox); Py_DECREF(cid); Py_DECREF(prob);
      Py_DECREF(det); Py_DECREF(label); Py_DECREF(status);
    }
    n = (int)nt;
  }
done:
  Py_XDECREF(tracks); Py_XDECREF(stat); Py_XDECREF(mod);
  if (PyErr_Occurred()) { PyErr_Print(); n = -1; }
  PyGILState_Release(gil);
  return n;
}

void dtpu_tracker_free(dtpu_tracker t)
{
  if (!t) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_DECREF((PyObject*)t);
  PyGILState_Release(gil);
}
