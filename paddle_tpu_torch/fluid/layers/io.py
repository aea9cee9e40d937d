"""Data layers and readers. Reference: python/paddle/fluid/layers/io.py
(JAX: fluid/layers/io.py), and the host-op layers Print (reference
layers/control_flow.py; JAX :323) and py_func (reference layers/nn.py;
JAX :752)."""

from ..layer_helper import LayerHelper

__all__ = ['data', 'py_reader', 'create_py_reader_by_data',
           'double_buffer', 'read_file', 'load', 'Print', 'py_func']


def data(name, shape, dtype='float32', lod_level=0, type=None,
         append_batch_size=True, stop_gradient=True):
    """Reference layers/io.py data: prepends -1 batch dim by default."""
    helper = LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.create_global_variable(
        name=name, shape=tuple(shape), dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True, persistable=False)


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Reference layers/io.py py_reader -> the GeneratorLoader path
    (fluid/reader.py): a non-iterable PyReader over data vars named
    '_py_reader_<i>_<name>'."""
    from ..reader import PyReader
    feed_list = []
    for i, (sh, dt) in enumerate(zip(shapes, dtypes)):
        # reference shapes include the (possibly concrete) batch dim;
        # data() prepends -1
        feed_list.append(data('_py_reader_%d_%s' % (i, name or ''),
                              shape=list(sh[1:]), dtype=dt))
    return PyReader(feed_list=feed_list, capacity=capacity,
                    use_double_buffer=use_double_buffer, iterable=False)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    from ..reader import PyReader
    return PyReader(feed_list=feed_list, capacity=capacity,
                    use_double_buffer=use_double_buffer, iterable=False)


def double_buffer(reader, place=None, name=None):
    """The PyReader's own staging is the double buffer (fluid/reader.py):
    an identity here."""
    return reader


def read_file(reader):
    """Reference layers/io.py read_file: the reader's feed vars (the
    executor feeds them)."""
    return reader.feed_vars if hasattr(reader, 'feed_vars') else reader


def load(out, file_path, load_as_fp16=None):
    """Reference layers/io.py load -> the load host op."""
    helper = LayerHelper('load')
    helper.append_op('load', inputs={}, outputs={'Out': out},
                     attrs={'file_path': file_path}, infer_shape=False)
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase='both'):
    """Reference operators/print_op.cc: the print host op."""
    helper = LayerHelper('print')
    helper.append_op('print', inputs={'In': input}, outputs={'Out': input},
                     attrs={'first_n': first_n, 'message': message or '',
                            'summarize': summarize},
                     infer_shape=False)
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Reference layers/nn.py py_func: a host Python op, forward only
    (operators/py_func_op.cc)."""
    from ...ops.host_ops import register_py_func
    helper = LayerHelper('py_func')
    fid = helper.name
    register_py_func(fid, func)
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    helper.append_op('py_func', inputs={'X': list(xs)},
                     outputs={'Out': list(outs)}, attrs={'func_id': fid},
                     infer_shape=False)
    return out
