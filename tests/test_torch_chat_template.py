"""The port's chat-template renderer (dynamo_tpu_torch.llm.chat_template)
against jinja2, through each package's OpenAIPreprocessor.render_chat.

The templates are written here in the form of the reference's default
(ChatML), Llama-3, Mistral and Qwen3 templates, plus one that exercises the
rest of the grammar and one whose raise_exception branch fires. Over
hypothesis messages (roles, unicode and template-like content, missing and
non-string content, content parts, extra keys) the two renderings must be
the same string, or both must fail: the reference with jinja2's error, the
port with its TemplateError. A template outside the grammar is refused when
the preprocessor is built: chat answers 400 and completions still serve.
"""

import copy

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.model_card import ModelDeploymentCard as RefCard
from dynamo_tpu.llm.preprocessor import DEFAULT_CHAT_TEMPLATE as REF_DEFAULT
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as RefPreprocessor
from dynamo_tpu.llm.preprocessor import RequestError as RefRequestError
from dynamo_tpu_torch.llm.chat_template import (
    ChatTemplate,
    TemplateError,
    TemplateSyntaxError,
)
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.validate import RequestError

CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + "
          "'\\n' + message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}"
          "{% endif %}")

LLAMA3 = """{{- bos_token }}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{{- "Cutting Knowledge Date: December 2023\\n\\n" }}
{{- system_message }}
{{- "<|eot_id|>" }}
{%- for message in messages %}
    {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

MISTRAL = """{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content'] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}
        {{- raise_exception('After the optional system message, conversation roles must alternate user/assistant/user/assistant/...') }}
    {%- endif %}
    {%- if message['role'] == 'user' %}
        {%- if loop.last and system_message is defined %}
            {{- '[INST] ' + system_message + '\\n\\n' + message['content'] + '[/INST]' }}
        {%- else %}
            {{- '[INST] ' + message['content'] + '[/INST]' }}
        {%- endif %}
    {%- elif message['role'] == 'assistant' %}
        {{- ' ' + message['content']|trim + eos_token|default('</s>') }}
    {%- else %}
        {{- raise_exception('Only user and assistant roles are supported, with the exception of an initial optional system message!') }}
    {%- endif %}
{%- endfor %}
"""

QWEN3 = """{%- if messages[0].role == 'system' %}
    {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if message.reasoning_content is string %}
            {%- set reasoning_content = message.reasoning_content %}
        {%- else %}
            {%- if '</think>' in content %}
                {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
                {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
            {%- endif %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}
"""

# The rest of the grammar: comments, loop unpacking, every loop attribute,
# filters, tests, literals, arithmetic, slices, string and dict methods,
# whitespace control.
GRAMMAR = """{#- every construct the renderer implements -#}
{% set ns = namespace(chars=0, roles=[]) -%}
{% for m in messages -%}
  [{{ loop.index }}/{{ loop.length }}|{{ loop.index0 }}|{{ loop.first }}|{{ loop.last }}]
  {%- set ns.chars = ns.chars + (m.content|string|length) %}
  {{ m.role|upper }} {{ m['role']|lower ~ '!' }} {{ m.content|tojson }}
  {{- m.get('name', 'anon') }} {{ m.keys()|length }} {{ m.values()|first|default('none') }}
  {%- if m.content is string and m.content.strip() %} first={{ m.content|first }} last={{ m.content|last }} {{ m.content.split()|join('+') }} {{ m.content|replace('a', 'A') }} {{ m.content[1:4] }} {{ m.content.startswith('a') }} {{ m.content.endswith(' ') }} {{ m.content.lstrip().rstrip()|trim }}{% elif m.content is none %} none{% elif m.content is number %} num={{ m.content * 2 }} {{ m.content // 3 }} {{ m.content % 4 }} {{ m.content ** 2 }} {{ -m.content }} {{ m.content / 2 }} {{ +m.content - 1 }}{% else %} other{% endif %}
{% endfor -%}
{% for k, v in {'b': 2, 'a': [1, 2.5, 'x', none, true]}|items %}{{ k }}={{ v|tojson }};{% endfor %}
{% for k, v in {'z': 1}.items() %}{{ k }}{{ v }}{% endfor %}
{{ [1, 2, 3][-1] }} {{ (1, 2) }} {{ 'x' in 'xyz' }} {{ 4 not in [1, 2] }} {{ '42'|int + 1 }} {{ 'z'|int }} {{ 'A b'.lower() }}{{ 'a'.upper() }}{{ 'aXa'.replace('X', '-') }}
{{ 1 < 2 and 2 >= 2 or false }} {{ not true }} {{ 1 if messages else 0 }} {{ 'adult' if ns.chars > 10 }} {{ 1 != 2 }} {{ 2 <= 1 }} {{ 3 > 2 }}
{{ messages|length is number }} {{ messages is sequence }} {{ messages[0] is mapping }} {{ none is none }} {{ messages is iterable }} {{ tools is undefined }} {{ true is true }} {{ false is not false }} {{ ns is defined }} {{ 'a' is string }}
{{- "  trimmed  "|trim -}}
{{ ns.chars }} {{ ns.missing|default('d') }} {{ undefined_name|length }} {{ 'a' ~ undefined_name ~ 'b' }}
"""

RAISE = ("{% for m in messages %}{% if m.role not in ['user', 'assistant', "
         "'system'] %}{{ raise_exception('unknown role ' + m.role) }}"
         "{% endif %}{{ m.role }}: {{ m.content }}\n{% endfor %}")

TEMPLATES = {"default": REF_DEFAULT, "chatml": CHATML, "llama3": LLAMA3,
             "mistral": MISTRAL, "qwen3": QWEN3, "grammar": GRAMMAR,
             "raise": RAISE}

_TEXT = st.one_of(
    st.text(max_size=20),
    st.sampled_from(["", " ", "\n", "hello world", "<think>r</think>\nans",
                     "<tool_response>x</tool_response>", "{{ x }}",
                     "{% if %}", "a\r\nb", "  padded  ", "ünï 😀 𝐀"]))
_CONTENT = st.one_of(_TEXT, _TEXT, st.none(), st.integers(-5, 50),
                     st.lists(st.fixed_dictionaries(
                         {"type": st.sampled_from(["text", "image_url"]),
                          "text": _TEXT}), max_size=2))
_MESSAGE = st.fixed_dictionaries(
    {"role": st.sampled_from(["system", "user", "assistant", "tool",
                              "developer"])},
    optional={"content": _CONTENT, "name": _TEXT,
              "reasoning_content": _TEXT})
_MESSAGES = st.lists(_MESSAGE, min_size=1, max_size=5)


def _outcome(render, messages):
    try:
        return "ok", render(copy.deepcopy(messages))
    except (RequestError, RefRequestError) as exc:
        return "request_error", str(exc)
    except TemplateError:
        return "template_error", None
    except Exception:  # noqa: BLE001 — jinja2's errors while rendering
        return "template_error", None


@pytest.fixture(scope="module")
def preprocessors():
    out = {}
    for name, source in TEMPLATES.items():
        ref = RefPreprocessor(RefCard(name="m", chat_template=source))
        port = OpenAIPreprocessor(ModelDeploymentCard(name="m",
                                                      chat_template=source))
        assert port.template is not None  # inside the grammar
        out[name] = (ref, port)
    return out


@settings(max_examples=60, deadline=None)
@given(messages=_MESSAGES)
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_renders_as_jinja2(preprocessors, name, messages):
    ref, port = preprocessors[name]
    want = _outcome(ref.render_chat, messages)
    got = _outcome(port.render_chat, messages)
    assert got == want


def test_the_templates_render_and_fail_where_they_should(preprocessors):
    """The fixed cases the hypothesis runs must not leave to chance."""
    user = [{"role": "user", "content": "hi"}]
    chat = [{"role": "system", "content": " sys "}, *user,
            {"role": "assistant", "content": "<think>why</think>\nyes"},
            {"role": "user", "content": "again"}]
    for name in TEMPLATES:
        ref, port = preprocessors[name]
        for messages in (user, chat):
            want = _outcome(ref.render_chat, messages)
            assert _outcome(port.render_chat, messages) == want
            if name != "mistral":
                assert want[0] == "ok", (name, want)
    ref, port = preprocessors["raise"]
    bad = [{"role": "tool", "content": "x"}]
    assert _outcome(ref.render_chat, bad) == ("template_error", None)
    with pytest.raises(TemplateError, match="raise_exception"):
        port.render_chat(copy.deepcopy(bad))
    # mistral: roles that do not alternate reach raise_exception
    ref, port = preprocessors["mistral"]
    two = [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}]
    assert _outcome(port.render_chat, two) == ("template_error", None)
    assert _outcome(ref.render_chat, two) == ("template_error", None)


@pytest.mark.parametrize("source", [
    "{% macro m() %}x{% endmacro %}{{ m() }}",
    "{% for m in messages if m.role %}{{ m }}{% endfor %}",
    "{% for m in messages %}{{ m }}{% else %}none{% endfor %}",
    "{{ loop.revindex }}",
    "{{ range(3)|list }}",
    "{% for m in messages %}{{ m|reject('x') }}{% endfor %}",
    "{{ messages[0].content.format(1) }}",
    "{% for m in messages recursive %}{{ loop(m) }}{% endfor %}",
    "{% set x %}block{% endset %}",
    "{% generation %}x{% endgeneration %}",
    "{{ loop.cycle('a', 'b') }}",
    "{{ messages.__class__ }}",
    "{% if x %}unclosed",
])
def test_outside_the_grammar_is_refused(source):
    with pytest.raises(TemplateSyntaxError):
        ChatTemplate(source)
    pre = OpenAIPreprocessor(ModelDeploymentCard(name="m",
                                                 chat_template=source))
    assert pre.template is None and pre.template_refused
    with pytest.raises(RequestError, match="outside the renderer's grammar"):
        pre.preprocess_chat({"messages": [{"role": "user",
                                           "content": "x"}]})
    # completions do not render the template
    assert pre.preprocess_completions({"prompt": "x"}).token_ids == [120]
