/* CPython extension: the SubNode record type + a bulk dict builder.
 *
 * The subgraph traversal (kreeq_tpu/core/subgraph.py) discovers ~1M
 * nodes per Mbp and must materialize {u64 key: SubNode} dicts in the
 * reference's insertion order (goldens pin GFA ids on it).  A
 * Python-side dataclass + per-item dict insert was the dominant share
 * of the whole traversal on the host.  This module provides:
 *
 *   SubNode(fw=None, bw=None, cov=0, color=0)  — attribute-compatible
 *     with core.subgraph.SubNode (fw/bw are mutable 4-lists,
 *     fw_count()/bw_count() methods), implemented as a C type;
 *   build_nodes(dst, n, keys_ptr, fw_ptr, bw_ptr, cov_ptr, color)
 *     — dst.update({keys[i]: SubNode(fw[i], bw[i], cov[i], color)})
 *     from contiguous u64/u32 numpy buffers, in index order.
 *     Duplicate keys keep their original dict position (CPython dict
 *     update semantics), matching the Python bulk-merge path.
 *
 * Reference analog: DBGkmer32color nodes filled by the traversal loop
 * (reference: src/subgraph.cpp:301-415, include/kreeq.h:126-136).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <stdint.h>

/* The type holds PyObject containers but is cycle-free by
 * construction: fw/bw are lists of ints and cov/color are ints on
 * every path this module creates (build_nodes and the default init),
 * so no GC support (tp_traverse) is needed.  Callers that assign a
 * container referencing the node back into node.fw would leak — the
 * Python SubNode call sites never do. */
typedef struct {
    PyObject_HEAD
    PyObject *fw;     /* list[4] */
    PyObject *bw;     /* list[4] */
    PyObject *cov;    /* int */
    PyObject *color;  /* int */
} SubNodeObject;

static PyTypeObject SubNodeType;  /* fwd */

static PyObject *zero_list4(void)
{
    PyObject *lst = PyList_New(4);
    if (!lst) return NULL;
    for (Py_ssize_t i = 0; i < 4; i++) {
        PyObject *z = PyLong_FromLong(0);
        if (!z) { Py_DECREF(lst); return NULL; }
        PyList_SET_ITEM(lst, i, z);
    }
    return lst;
}

static int
subnode_init(SubNodeObject *self, PyObject *args, PyObject *kwds)
{
    static char *kwlist[] = {"fw", "bw", "cov", "color", NULL};
    PyObject *fw = NULL, *bw = NULL, *cov = NULL, *color = NULL;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "|OOOO", kwlist,
                                     &fw, &bw, &cov, &color))
        return -1;
    PyObject *nfw = (fw && fw != Py_None) ? (Py_INCREF(fw), fw)
                                          : zero_list4();
    if (!nfw) return -1;
    PyObject *nbw = (bw && bw != Py_None) ? (Py_INCREF(bw), bw)
                                          : zero_list4();
    if (!nbw) { Py_DECREF(nfw); return -1; }
    PyObject *ncov = cov ? (Py_INCREF(cov), cov) : PyLong_FromLong(0);
    if (!ncov) { Py_DECREF(nfw); Py_DECREF(nbw); return -1; }
    PyObject *ncol = color ? (Py_INCREF(color), color)
                           : PyLong_FromLong(0);
    if (!ncol) { Py_DECREF(nfw); Py_DECREF(nbw); Py_DECREF(ncov);
                 return -1; }
    Py_XSETREF(self->fw, nfw);
    Py_XSETREF(self->bw, nbw);
    Py_XSETREF(self->cov, ncov);
    Py_XSETREF(self->color, ncol);
    return 0;
}

static void
subnode_dealloc(SubNodeObject *self)
{
    Py_XDECREF(self->fw);
    Py_XDECREF(self->bw);
    Py_XDECREF(self->cov);
    Py_XDECREF(self->color);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *
count_nonzero(PyObject *lst)
{
    if (!PyList_Check(lst)) {
        PyErr_SetString(PyExc_TypeError, "edge field is not a list");
        return NULL;
    }
    long n = 0;
    Py_ssize_t len = PyList_GET_SIZE(lst);
    for (Py_ssize_t i = 0; i < len; i++) {
        int t = PyObject_IsTrue(PyList_GET_ITEM(lst, i));
        if (t < 0) return NULL;
        n += t;
    }
    return PyLong_FromLong(n);
}

static PyObject *
subnode_fw_count(SubNodeObject *self, PyObject *Py_UNUSED(ignored))
{
    return count_nonzero(self->fw);
}

static PyObject *
subnode_bw_count(SubNodeObject *self, PyObject *Py_UNUSED(ignored))
{
    return count_nonzero(self->bw);
}

static PyMethodDef subnode_methods[] = {
    {"fw_count", (PyCFunction)subnode_fw_count, METH_NOARGS,
     "number of non-zero forward edge counters"},
    {"bw_count", (PyCFunction)subnode_bw_count, METH_NOARGS,
     "number of non-zero backward edge counters"},
    {NULL, NULL, 0, NULL},
};

static PyMemberDef subnode_members[] = {
    {"fw", T_OBJECT_EX, offsetof(SubNodeObject, fw), 0, "fw edges"},
    {"bw", T_OBJECT_EX, offsetof(SubNodeObject, bw), 0, "bw edges"},
    {"cov", T_OBJECT_EX, offsetof(SubNodeObject, cov), 0, "coverage"},
    {"color", T_OBJECT_EX, offsetof(SubNodeObject, color), 0, "color"},
    {NULL, 0, 0, 0, NULL},
};

static PyTypeObject SubNodeType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "subnode_ext.SubNode",
    .tp_basicsize = sizeof(SubNodeObject),
    .tp_dealloc = (destructor)subnode_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
    .tp_doc = "DBGkmer32color-equivalent record (C fast path)",
    .tp_methods = subnode_methods,
    .tp_members = subnode_members,
    .tp_init = (initproc)subnode_init,
    .tp_new = PyType_GenericNew,
};

/* build_nodes(dst, n, keys_ptr, fw_ptr, bw_ptr, cov_ptr, color) */
static PyObject *
build_nodes(PyObject *Py_UNUSED(mod), PyObject *args)
{
    PyObject *dst;
    Py_ssize_t n;
    unsigned long long keys_p, fw_p, bw_p, cov_p;
    long color;
    if (!PyArg_ParseTuple(args, "OnKKKKl", &dst, &n, &keys_p, &fw_p,
                          &bw_p, &cov_p, &color))
        return NULL;
    if (!PyDict_Check(dst)) {
        PyErr_SetString(PyExc_TypeError, "dst must be a dict");
        return NULL;
    }
    const uint64_t *keys = (const uint64_t *)keys_p;
    const uint32_t *fw = (const uint32_t *)fw_p;
    const uint32_t *bw = (const uint32_t *)bw_p;
    const uint32_t *cov = (const uint32_t *)cov_p;

    PyObject *color_obj = PyLong_FromLong(color);
    if (!color_obj) return NULL;

    for (Py_ssize_t i = 0; i < n; i++) {
        SubNodeObject *node = PyObject_New(SubNodeObject, &SubNodeType);
        if (!node) goto fail;
        node->fw = NULL; node->bw = NULL;
        node->cov = NULL; node->color = NULL;
        node->fw = PyList_New(4);
        node->bw = PyList_New(4);
        node->cov = PyLong_FromUnsignedLong(cov[i]);
        Py_INCREF(color_obj);
        node->color = color_obj;
        if (!node->fw || !node->bw || !node->cov) {
            Py_DECREF(node); goto fail;
        }
        for (int w = 0; w < 4; w++) {
            PyObject *f = PyLong_FromUnsignedLong(fw[4 * i + w]);
            PyObject *b = PyLong_FromUnsignedLong(bw[4 * i + w]);
            if (!f || !b) { Py_XDECREF(f); Py_XDECREF(b);
                            Py_DECREF(node); goto fail; }
            PyList_SET_ITEM(node->fw, w, f);
            PyList_SET_ITEM(node->bw, w, b);
        }
        PyObject *key = PyLong_FromUnsignedLongLong(keys[i]);
        if (!key) { Py_DECREF(node); goto fail; }
        int rc = PyDict_SetItem(dst, key, (PyObject *)node);
        Py_DECREF(key);
        Py_DECREF(node);
        if (rc < 0) goto fail;
    }
    Py_DECREF(color_obj);
    Py_RETURN_NONE;
fail:
    Py_DECREF(color_obj);
    return NULL;
}

static PyMethodDef module_methods[] = {
    {"build_nodes", build_nodes, METH_VARARGS,
     "bulk {u64 key: SubNode} dict update from contiguous buffers"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef subnode_module = {
    PyModuleDef_HEAD_INIT, "subnode_ext",
    "C fast path for subgraph node records", -1, module_methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC
PyInit_subnode_ext(void)
{
    if (PyType_Ready(&SubNodeType) < 0) return NULL;
    PyObject *m = PyModule_Create(&subnode_module);
    if (!m) return NULL;
    Py_INCREF(&SubNodeType);
    if (PyModule_AddObject(m, "SubNode",
                           (PyObject *)&SubNodeType) < 0) {
        Py_DECREF(&SubNodeType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
