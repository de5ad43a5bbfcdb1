/* fastio: the host-side IO hot paths of gaussian_mesh_splatting_tpu_torch, as
 * a CPython extension (the port's copy of native/fastio.c).
 *
 *   - parse_ply_vertices(bytes, header_offset, n, prop_sizes)
 *       -> list of 1-D float32/uint8 numpy arrays: the columns of a packed
 *          binary_little_endian vertex element, written directly (the numpy
 *          path materializes a record array first).
 *   - parse_colmap_points3d(bytes) -> (xyz f64 (N,3), rgb u8 (N,3), err f64 (N,1))
 *       COLMAP points3D.bin, whose variable-length track lists a vectorized
 *       numpy reader cannot step over without a Python loop.
 *
 * Built at first use by io/native.py with cc; io/ply.py and
 * scene/colmap_loader.py keep their numpy paths for when it is absent.
 * The records are read in the host's byte order: little-endian hosts only.
 */
#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>
#include <stdint.h>
#include <string.h>

static PyObject *
parse_ply_vertices(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    Py_ssize_t offset, count;
    PyObject *sizes_obj; /* list of per-property byte sizes (4: float32, 1: uint8) */
    if (!PyArg_ParseTuple(args, "y*nnO!", &buf, &offset, &count, &PyList_Type, &sizes_obj))
        return NULL;

    PyObject *out = NULL;
    char **dsts = NULL; /* each column's data */
    Py_ssize_t nprops = PyList_GET_SIZE(sizes_obj);
    long *sizes = (long *)PyMem_Malloc(sizeof(long) * (size_t)(nprops > 0 ? nprops : 1));
    if (sizes == NULL) {
        PyErr_NoMemory();
        goto done;
    }
    long stride = 0;
    for (Py_ssize_t i = 0; i < nprops; i++) {
        sizes[i] = PyLong_AsLong(PyList_GET_ITEM(sizes_obj, i));
        if (sizes[i] == -1 && PyErr_Occurred())
            goto done;
        if (sizes[i] != 1 && sizes[i] != 4) {
            PyErr_SetString(PyExc_ValueError, "property sizes must be 1 or 4 bytes");
            goto done;
        }
        stride += sizes[i];
    }
    if (offset < 0 || count < 0 || offset + count * stride > buf.len) {
        PyErr_SetString(PyExc_ValueError, "buffer too small for vertex element");
        goto done;
    }

    out = PyList_New(nprops);
    if (out == NULL)
        goto done;
    dsts = (char **)PyMem_Malloc(sizeof(char *) * (size_t)(nprops > 0 ? nprops : 1));
    if (dsts == NULL) {
        PyErr_NoMemory();
        Py_CLEAR(out);
        goto done;
    }
    for (Py_ssize_t i = 0; i < nprops; i++) {
        npy_intp dims[1] = {count};
        PyArrayObject *arr = (PyArrayObject *)PyArray_SimpleNew(
            1, dims, sizes[i] == 4 ? NPY_FLOAT32 : NPY_UINT8);
        if (arr == NULL) {
            Py_CLEAR(out);
            goto done;
        }
        dsts[i] = (char *)PyArray_DATA(arr);
        PyList_SET_ITEM(out, i, (PyObject *)arr);
    }
    /* one pass over the records, each value to its column; a constant copy
       size lets the compiler make each copy one load and one store */
    const char *src = (const char *)buf.buf + offset;
    for (Py_ssize_t r = 0; r < count; r++) {
        for (Py_ssize_t i = 0; i < nprops; i++) {
            if (sizes[i] == 4) {
                memcpy(dsts[i] + r * 4, src, 4);
                src += 4;
            } else {
                dsts[i][r] = *src++;
            }
        }
    }

done:
    PyMem_Free(dsts);
    PyMem_Free(sizes);
    PyBuffer_Release(&buf);
    return out;
}

static PyObject *
parse_colmap_points3d(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf))
        return NULL;
    const uint8_t *p = (const uint8_t *)buf.buf;
    const uint8_t *end = p + buf.len;
    PyArrayObject *xyz = NULL, *rgb = NULL, *err = NULL;
    PyObject *out = NULL;
    if (buf.len < 8) {
        PyErr_SetString(PyExc_ValueError, "truncated points3D.bin");
        goto done;
    }
    uint64_t n;
    memcpy(&n, p, 8);
    p += 8;
    /* every record is at least 51 bytes: a count beyond that is corrupt */
    if (n > (uint64_t)(buf.len - 8) / 51) {
        PyErr_SetString(PyExc_ValueError, "truncated points3D.bin record");
        goto done;
    }

    npy_intp d3[2] = {(npy_intp)n, 3};
    npy_intp d1[2] = {(npy_intp)n, 1};
    xyz = (PyArrayObject *)PyArray_SimpleNew(2, d3, NPY_FLOAT64);
    rgb = (PyArrayObject *)PyArray_SimpleNew(2, d3, NPY_UINT8);
    err = (PyArrayObject *)PyArray_SimpleNew(2, d1, NPY_FLOAT64);
    if (xyz == NULL || rgb == NULL || err == NULL)
        goto done;
    double *xyz_d = (double *)PyArray_DATA(xyz);
    uint8_t *rgb_d = (uint8_t *)PyArray_DATA(rgb);
    double *err_d = (double *)PyArray_DATA(err);

    for (uint64_t i = 0; i < n; i++) {
        /* id(8) xyz(24) rgb(3) err(8) track_len(8) track(8*len) */
        if (end - p < 51) {
            PyErr_SetString(PyExc_ValueError, "truncated points3D.bin record");
            goto done;
        }
        memcpy(&xyz_d[i * 3], p + 8, 24);
        memcpy(&rgb_d[i * 3], p + 32, 3);
        memcpy(&err_d[i], p + 35, 8);
        uint64_t track_len;
        memcpy(&track_len, p + 43, 8);
        p += 51;
        if (track_len > (uint64_t)(end - p) / 8) {
            PyErr_SetString(PyExc_ValueError, "truncated points3D.bin record");
            goto done;
        }
        p += track_len * 8;
    }
    out = Py_BuildValue("(OOO)", xyz, rgb, err);

done:
    Py_XDECREF(xyz);
    Py_XDECREF(rgb);
    Py_XDECREF(err);
    PyBuffer_Release(&buf);
    return out;
}

static PyMethodDef Methods[] = {
    {"parse_ply_vertices", parse_ply_vertices, METH_VARARGS,
     "Split packed binary PLY vertex records into column arrays."},
    {"parse_colmap_points3d", parse_colmap_points3d, METH_VARARGS,
     "Parse COLMAP points3D.bin into (xyz, rgb, error) arrays."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastio", NULL, -1, Methods};

PyMODINIT_FUNC
PyInit_fastio(void)
{
    import_array();
    return PyModule_Create(&moduledef);
}
